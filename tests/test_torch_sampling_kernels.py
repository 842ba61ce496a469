"""The plain versions of K13 (kernels/mppi.py) and K14 (kernels/pf_resample.py)
of numpower_tpu_torch against the JAX package's Pallas kernels in interpret
mode, on the same inputs (CPU).

On a CPU tensor each wrapper runs its kernel's plain version and counts no
launch. K13: the JAX package's kernel-layout perturbations (its "exact"
stream) at N = 6, which takes its scenario padding path; bounds us atol 5e-4,
ess rtol 1e-3 (tests/test_kernels.py:503-536). K14: element-exact, with the
degenerate weight spike of tests/test_kernels.py:341-360.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import numpower_tpu.models as jm  # noqa: E402
import numpower_tpu_torch.models as tm  # noqa: E402
from numpower_tpu.kernels import mppi as jk  # noqa: E402
from numpower_tpu.kernels.pf_resample import resample_onehot_pallas  # noqa: E402
from numpower_tpu.models import particle as jpart  # noqa: E402
from numpower_tpu_torch.kernels import mppi as tk  # noqa: E402
from numpower_tpu_torch.kernels import pf_resample  # noqa: E402
from numpower_tpu_torch.models import mppi as tmppi  # noqa: E402

QP = np.diag([1.0, 0.1]).astype(np.float32)
RP = np.eye(1, dtype=np.float32) * 0.01
QFP = np.diag([100.0, 10.0]).astype(np.float32)
T, K, N = 12, 128, 6
US0 = (0.1 * np.random.default_rng(8).standard_normal((T, 1))).astype(np.float32)
CONFIGS = {  # the configurations of test_mppi_pallas_matches_xla
    "plain": dict(iters=4, m=1),
    "box_sigma_lam": dict(iters=3, m=1, u_lo=-2.0, u_hi=2.0, sigma=0.7, lam=0.5),
    "warm_start": dict(iters=2, us_init=US0),
}


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_plain_k13_matches_the_pallas_kernel(name):
    """K13's wrapper on a CPU tensor and the whole kernel route of the
    batched solve on the same eps, against JAX's mppi_pallas in interpret
    mode."""
    kw = dict(CONFIGS[name])
    cj = jm.quadratic_mppi_cost(jnp.asarray(QP), jnp.asarray(RP), jnp.asarray(QFP), jnp.zeros(2))
    ct = tm.quadratic_mppi_cost(QP, RP, QFP, np.zeros(2, np.float32))
    x0s = np.random.default_rng(8).uniform(-np.pi, np.pi, (N, 2)).astype(np.float32)
    m = kw.pop("m", 1)
    iters = kw.pop("iters")
    us_init = kw.pop("us_init", None)
    sig = tk.sigma_tuple(kw.get("sigma", 1.0), m)
    lay = np.asarray(jk.eps_kernel_layout(jax.random.key(3), N, iters, T, m, K,
                                          jnp.asarray(sig, jnp.float32)))
    us0 = np.zeros(T * m, np.float32) if us_init is None else us_init.reshape(-1)
    lam = float(kw.get("lam", 1.0))
    us_j, ess_j = jk.mppi_pallas(
        jm.pendulum_step, cj.rows, jnp.asarray(x0s), jnp.asarray(lay), jnp.asarray(us0), T=T,
        iters=iters, m=m, lam=lam, sigma=sig, u_lo=kw.get("u_lo"), u_hi=kw.get("u_hi"),
        interpret=True)
    before = tk.mppi_fused.launches
    us_t, ess_t = tk.mppi_fused(tm.pendulum_step, ct, _t(x0s), _t(lay), _t(us0), T=T, iters=iters,
                                m=m, lam=lam, sigma=kw.get("sigma", 1.0), u_lo=kw.get("u_lo"),
                                u_hi=kw.get("u_hi"))
    assert tk.mppi_fused.launches == before  # no kernel on the CPU
    assert us_t.shape == (N, T, m) and ess_t.shape == (N, iters)
    np.testing.assert_allclose(us_t.numpy(), np.asarray(us_j), rtol=0, atol=5e-4)
    np.testing.assert_allclose(ess_t.numpy(), np.asarray(ess_j), rtol=1e-3)
    got = tmppi._mppi_kernel_core(tm.pendulum_step, _t(x0s), ct, _t(lay), T, iters, m,
                                  us_init=us_init, **kw)
    np.testing.assert_allclose(got.us.numpy(), np.asarray(us_j), rtol=0, atol=5e-4)
    np.testing.assert_allclose(got.ess.numpy(), np.asarray(ess_j)[:, -1], rtol=1e-3)


def test_eps_layouts():
    g = torch.Generator().manual_seed(2)
    plain = tk.draw_eps(g, 3, 2, 5, 4, 2, (1.0, 0.5))
    lay = tk.eps_kernel_layout(torch.Generator().manual_seed(2), 3, 2, 4, 2, 5, (1.0, 0.5))
    assert lay.shape == (2 * 4 * 2, 3, 5)
    assert torch.equal(lay.reshape(2, 4, 2, 3, 5).permute(3, 0, 4, 1, 2), plain)
    direct = tk.eps_direct_layout(torch.Generator().manual_seed(2), 3, 2, 4, 2, 5, (1.0, 0.5))
    raw = torch.randn((16, 3, 5), generator=torch.Generator().manual_seed(2))
    assert torch.equal(direct[0::2], raw[0::2]) and torch.equal(direct[1::2], raw[1::2] * 0.5)


def test_kernel_operands_are_checked():
    """What K13 does not take is refused before any launch, whatever the
    device (the wrapper checks these on the card)."""
    ct = tm.quadratic_mppi_cost(QP, RP, QFP, np.zeros(2, np.float32))
    x0s, eps = torch.zeros((2, 2)), torch.zeros((2 * T, 2, 8))
    with pytest.raises(ValueError, match="not registered"):
        tk.kernel_operands(lambda x, u: x, ct, x0s, eps, None, T=T, iters=2, m=1, sigma=1.0)
    with pytest.raises(ValueError, match="kernel form"):
        tk.kernel_operands(tm.pendulum_step, lambda x, u, t: x, x0s, eps, None, T=T, iters=2,
                           m=1, sigma=1.0)
    with pytest.raises(ValueError, match="rows"):
        tk.kernel_operands(tm.pendulum_step, ct, x0s, eps, None, T=T, iters=3, m=1, sigma=1.0)
    # past the narrow K13's K = 1024 the wide one takes the launch; an empty
    # sample axis and T m past the wide one's shared memory are refused
    tk.kernel_operands(tm.pendulum_step, ct, x0s, torch.zeros((2 * T, 2, 1025)),
                       torch.zeros(T), T=T, iters=2, m=1, sigma=1.0)
    with pytest.raises(ValueError, match="1 <= K"):
        tk.kernel_operands(tm.pendulum_step, ct, x0s, torch.zeros((2 * T, 2, 0)), None, T=T,
                           iters=2, m=1, sigma=1.0)
    with pytest.raises(ValueError, match="1 <= K"):
        tk.kernel_operands(tm.pendulum_step, ct, x0s, torch.zeros((2 * 32769, 2, 8)), None,
                           T=32769, iters=2, m=1, sigma=1.0)


@pytest.mark.parametrize("K", [1, 33, 256, 257, 1024])
@pytest.mark.parametrize("T,m", [(1, 1), (40, 1), (30, 2), (1024, 1), (512, 2)])
def test_chunk_plan_fits_the_kernels_budgets(K, T, m):
    """The plan csrc/mppi.cu checks: whole warps, at most MAX_THREADS, every
    sample carried; Tc steps a chunk, ceil(T / Tc) chunks; the ring within
    its budget, resident (a round's chunks and one more) where that fits,
    for the largest chunk that does, else four slots streaming."""
    threads, spt, tc, nch, resident = tk.chunk_plan(K, T, m)
    assert threads % 32 == 0 and threads <= tk.MAX_THREADS and threads * spt >= K
    assert spt == (1 if K <= 256 else 2 if K <= 512 else 4) and threads - 32 < -(-K // spt)
    assert 1 <= tc <= min(tk.MAX_TC, T) and nch == -(-T // tc)
    step_bytes = 4 * m * spt * threads
    if resident:
        assert (nch + 1) * tc * step_bytes <= tk.RESIDENT_BUDGET
        if tc < min(tk.MAX_TC, T):
            assert (-(-T // (tc + 1)) + 1) * (tc + 1) * step_bytes > tk.RESIDENT_BUDGET
    else:
        assert all((-(-T // c) + 1) * c * step_bytes > tk.RESIDENT_BUDGET
                   for c in range(1, min(tk.MAX_TC, T) + 1))
        assert 4 * tc * step_bytes <= tk.STREAM_BUDGET or tc == 1


def test_chunk_plan_at_the_bench_and_past_the_budget():
    """The MPPI bench's shape stays resident (5 chunks of 8 steps and one
    more, 48 KB); 1024 samples of an m = 2 plant over 16 steps stream, a
    step a chunk; one sample over 320 steps stays resident in 40 chunks."""
    assert tk.chunk_plan(256, 40, 1) == (256, 1, 8, 5, True)
    assert 6 * 8 * 4 * 256 == 49152 <= tk.RESIDENT_BUDGET
    assert tk.chunk_plan(1024, 16, 2) == (256, 4, 1, 16, False)
    assert tk.chunk_plan(1, 320, 1) == (32, 1, 8, 40, True)
    assert tk.chunk_plan(257, 20, 1) == (160, 2, 8, 3, True)


def test_packed_constants_are_made_once_per_cost_and_sigma():
    """K13's by-value constants: Q, R, QF, x_goal, sigma^-2 in that order as
    float32 on the host, made once per cost and sigma (no per-call upload)."""
    goal = np.array([0.5, -0.25], np.float32)
    ct = tm.quadratic_mppi_cost(QP, RP, QFP, goal)
    c1 = tk.packed_constants(ct, 1.0, 2, 1)
    assert tk.packed_constants(ct, 1.0, 2, 1) is c1
    c2 = tk.packed_constants(ct, 0.5, 2, 1)
    assert c2 is not c1
    want = np.concatenate([np.asarray(QP, np.float32).ravel(), np.asarray(RP, np.float32).ravel(),
                           np.asarray(QFP, np.float32).ravel(), goal, [4.0]]).astype(np.float32)
    assert np.array_equal(np.ctypeslib.as_array(c2), want)
    with pytest.raises(ValueError, match="shape"):
        tk.packed_constants(ct, 1.0, 3, 1)
    with pytest.raises(ValueError, match="kernel form"):
        tk.packed_constants(lambda x, u, t: x, 1.0, 2, 1)


def _slots(logw, u0):
    """The JAX package's slot boundaries for each row (its _resample_slots
    with the offset u0 given)."""
    out = []
    for lw, u in zip(logw, u0):
        w = jnp.exp(lw - jax.scipy.special.logsumexp(lw))
        cum = jnp.cumsum(w)
        cum = cum / cum[-1]
        out.append(np.asarray(jnp.clip(jnp.floor(len(lw) * cum - u).astype(jnp.int32) + 1, 0,
                                       len(lw))))
    return np.stack(out).astype(np.int32)


@pytest.mark.parametrize("N_p", [256, 257])
def test_plain_k14_matches_the_pallas_kernel(N_p):
    """Element-exact against resample_onehot_pallas in interpret mode and the
    JAX package's one-hot construction, with a near-degenerate weight spike
    in one trajectory."""
    rng = np.random.default_rng(7)
    B, n = 3, 5
    parts = rng.standard_normal((B, N_p, n)).astype(np.float32)
    logw = rng.standard_normal((B, N_p)).astype(np.float32)
    logw[1, 17] = 25.0
    keys = jax.random.split(jax.random.key(5), B)
    m = np.asarray(jax.vmap(lambda k, lw: jpart._resample_slots(k, lw, N_p))(keys,
                                                                          jnp.asarray(logw)))
    blk = 128 if N_p % 128 == 0 else N_p
    want = np.asarray(resample_onehot_pallas(jnp.asarray(parts), jnp.asarray(m), blk=blk,
                                             interpret=True))
    before = pf_resample.resample_systematic.launches
    got = pf_resample.resample_systematic(_t(parts), _t(m))
    assert pf_resample.resample_systematic.launches == before  # no kernel on the CPU
    np.testing.assert_array_equal(got.numpy(), want)
    ref = jax.vmap(lambda k, p, lw: jpart._systematic_resample(k, p, lw, method="onehot")[0])(
        keys, jnp.asarray(parts), jnp.asarray(logw))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # the spike owns (almost) every slot of its row
    assert int((got[1] == _t(parts[1, 17])).all(dim=-1).sum()) >= N_p - 2


@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 7, 3), (4, 33, 2), (1, 1024, 6)])
def test_plain_k14_is_the_slot_assignment(shape):
    """out[b, i] = parts[b, j] for the unique j with m[b, j-1] <= i < m[b, j],
    a row of zeros where no j owns i (a row of m that stops short of N), on
    any (B, N, n) including N = 1 and odd N."""
    B, N_p, n = shape
    rng = np.random.default_rng(sum(shape))
    parts = rng.standard_normal(shape).astype(np.float32)
    logw = (3.0 * rng.standard_normal((B, N_p))).astype(np.float32)
    m = _slots(logw, rng.uniform(size=B).astype(np.float32))
    m[0, -1] = max(m[0, -1] - 1, 0)  # one slot owned by nobody in the first row
    m[0] = np.minimum(m[0], m[0, -1])
    want = np.zeros_like(parts)
    for b in range(B):
        prev = 0
        for j in range(N_p):
            want[b, prev:m[b, j]] = parts[b, j]
            prev = max(prev, m[b, j])
    got = pf_resample.resample_systematic(_t(parts), _t(m))
    np.testing.assert_array_equal(got.numpy(), want)
