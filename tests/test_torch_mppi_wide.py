"""K13 past the narrow kernel's K = 1024 samples and T*m = 1024 nominal
entries (the wide form, csrc/mppi_wide.cu) in numpower_tpu_torch, against the
JAX package on the same numpy inputs and the JAX package's own draws (CPU).

On a CPU tensor the wrapper runs the kernels' plain version, whatever the
size; these tests hold that version, the kernel route's core and the route
table at the sizes the wide kernel takes on the card:
- the JAX kernel mppi_pallas in interpret mode at K = 1152 and 2048
  (T = 12, 2 rounds, with and without the box), on its kernel-layout draw;
- the JAX XLA route at T*m = 1280 (the unicycle over T = 640, lam = 1e3,
  N = 2, K = 128, one round; an interpret-mode trace 1280 rows deep is too
  slow here), on its own key;
- the route against the JAX route's eligibility (samples % 128 == 0), the
  wide plan's budgets and the operand checks past the narrow envelope.
Bounds: us atol 5e-4, ess rtol 1e-3 (tests/test_kernels.py:503-536 of the JAX
package). The kernel itself runs in tests/test_torch_mppi_wide_cuda.py.
"""

import math
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import numpower_tpu.models as jm  # noqa: E402
import numpower_tpu_torch.models as tm  # noqa: E402
from numpower_tpu.kernels import mppi as jk  # noqa: E402
from numpower_tpu_torch.kernels import _build  # noqa: E402
from numpower_tpu_torch.kernels import mppi as tk  # noqa: E402
from numpower_tpu_torch.models import mppi as tmppi  # noqa: E402

# the bench's swing-up cost (bench.py:546-572) and the card tests' unicycle cost
QP, RP, QFP = np.diag([1.0, 0.1]), 0.01 * np.eye(1), np.diag([100.0, 10.0])
QU, RU, QFU = np.diag([1.0, 1.0, 0.0]), 0.01 * np.eye(2), np.diag([50.0, 50.0, 0.0])
GOAL_U = np.array([1.0, 1.0, 0.0])
BOUND = dict(us=5e-4, ess=1e-3)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _costs(Q, R, QF, goal):
    f32 = [np.asarray(M, np.float32) for M in (Q, R, QF, goal)]
    return jm.quadratic_mppi_cost(*map(jnp.asarray, f32)), tm.quadratic_mppi_cost(*f32)


@pytest.mark.parametrize("box", [False, True], ids=["free", "box"])
@pytest.mark.parametrize("K,N", [(1152, 6), (2048, 2)])
def test_wide_k13_matches_the_pallas_kernel(K, N, box):
    """mppi_pallas and mppi_fused of the port on CPU tensors, and the kernel
    route's core, against JAX's mppi_pallas in interpret mode at K past the
    narrow kernel's 1024 (N = 6 takes JAX's scenario padding)."""
    T, iters = 12, 2
    cj, ct = _costs(QP, RP, QFP, np.zeros(2))
    x0s = np.random.default_rng(K).uniform(-np.pi, np.pi, (N, 2)).astype(np.float32)
    us0 = (0.1 * np.random.default_rng(K + 1).standard_normal(T)).astype(np.float32)
    opts = dict(u_lo=-2.0, u_hi=2.0, sigma=0.7, lam=0.5) if box else \
        dict(u_lo=None, u_hi=None, sigma=1.0, lam=1.0)
    sig = tk.sigma_tuple(opts["sigma"], 1)
    lay = np.asarray(jk.eps_kernel_layout(jax.random.key(K), N, iters, T, 1, K,
                                          jnp.asarray(sig, jnp.float32)))
    kw = dict(T=T, iters=iters, m=1, lam=opts["lam"], sigma=sig, u_lo=opts["u_lo"],
              u_hi=opts["u_hi"])
    us_j, ess_j = jk.mppi_pallas(jm.pendulum_step, cj.rows, jnp.asarray(x0s), jnp.asarray(lay),
                                 jnp.asarray(us0), **kw, interpret=True)
    assert not tk.is_narrow(K, T, 1) and tk.kernel_function(K, T, 1) == "npt_mppi_wide"
    before = tk.mppi_fused.launches
    for fn in (tk.mppi_pallas, tk.mppi_fused):
        cost = ct.rows if fn is tk.mppi_pallas else ct
        us, ess = fn(tm.pendulum_step, cost, _t(x0s), _t(lay), _t(us0), **kw)
        assert us.shape == (N, T, 1) and ess.shape == (N, iters)
        np.testing.assert_allclose(us.numpy(), np.asarray(us_j), rtol=0, atol=BOUND["us"])
        np.testing.assert_allclose(ess.numpy(), np.asarray(ess_j), rtol=BOUND["ess"])
    assert tk.mppi_fused.launches == before  # no kernel on the CPU
    got = tmppi._mppi_kernel_core(tm.pendulum_step, _t(x0s), ct, _t(lay), T, iters, 1,
                                  lam=opts["lam"], sigma=opts["sigma"], u_lo=opts["u_lo"],
                                  u_hi=opts["u_hi"], us_init=_t(us0))
    np.testing.assert_allclose(got.us.numpy(), np.asarray(us_j), rtol=0, atol=BOUND["us"])
    np.testing.assert_allclose(got.ess.numpy(), np.asarray(ess_j)[:, -1], rtol=BOUND["ess"])
    if box:
        assert float(got.us.abs().max()) <= 2.0


def test_wide_k13_past_tm_1024_matches_the_xla_route():
    """T*m = 1280 (the unicycle over T = 640): the kernel route's core on
    the JAX package's exact stream against JAX's "xla" route from the same
    key (both draw split(key, N), then split(k, iters) per scenario). Over
    so long a horizon the costs reach 1e3-1e4; a high temperature keeps the
    weights off a last-bit difference of the plant's sin/cos."""
    N, K, T, m, iters, lam = 2, 128, 640, 2, 1, 1e3
    cj, ct = _costs(QU, RU, QFU, GOAL_U)
    x0s = (0.3 * np.random.default_rng(12).standard_normal((N, 3))).astype(np.float32)
    key = jax.random.key(12)
    kw = dict(samples=K, iters=iters, m=m, lam=lam)
    want = jm.mppi_solve_batched(jm.unicycle_step, jnp.asarray(x0s), cj, T, key, method="xla",
                                 **kw)
    lay = np.asarray(jk.eps_kernel_layout(key, N, iters, T, m, K, jnp.ones(m, jnp.float32)))
    assert tmppi.route_mppi("cuda", torch.float32, ct, K, T, m, 0.0) == "pallas"
    assert not tk.is_narrow(K, T, m) and tk.wide_plan(K) == (128, 1, 1)
    got = tmppi._mppi_kernel_core(tm.unicycle_step, _t(x0s), ct, _t(lay), T, iters, m, lam=lam)
    assert got.us.shape == (N, T, m) and got.xs.shape == (N, T + 1, 3)
    np.testing.assert_allclose(got.us.numpy(), np.asarray(want.us), rtol=0, atol=BOUND["us"])
    np.testing.assert_allclose(got.ess.numpy(), np.asarray(want.ess), rtol=BOUND["ess"])
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost), rtol=1e-4)


@pytest.mark.parametrize("samples", [1152, 2048, 4096, 2000])
def test_routes_follow_the_jax_rule_past_1024(samples):
    """"auto" on a float32 CUDA tensor takes K13 exactly where the JAX route
    takes its kernel (samples % 128 == 0), at every K: an explicit "pallas"
    raises where the JAX route raises (samples = 2000, or baseline_mix > 0),
    and only past the wide kernel's T*m = 32768 beside that."""
    cj, ct = _costs(QP, RP, QFP, np.zeros(2))
    route = tmppi.route_mppi
    eligible = samples % 128 == 0
    x0s, T = np.zeros((2, 2), np.float32), 40
    assert route("cuda", torch.float32, ct, samples, T, 1, 0.0) == ("pallas" if eligible
                                                                     else "xla")
    assert route("cpu", torch.float32, ct, samples, T, 1, 0.0) == "xla"
    assert route("cuda", torch.float64, ct, samples, T, 1, 0.0) == "xla"
    assert route("cuda", torch.float32, ct, samples, T, 1, 0.25) == "xla"
    for mix in (0.0, 0.25):
        if eligible and mix == 0.0:
            assert route("cuda", torch.float32, ct, samples, T, 1, mix, method="pallas") == \
                "pallas"
            continue
        with pytest.raises(ValueError, match="samples % 128 == 0"):
            route("cuda", torch.float32, ct, samples, T, 1, mix, method="pallas")
        with pytest.raises(ValueError, match="samples % 128 == 0"):
            jm.mppi_solve_batched(jm.pendulum_step, jnp.asarray(x0s), cj, T, jax.random.key(0),
                                  method="pallas", samples=samples, iters=1, m=1,
                                  baseline_mix=mix)
    # the wide kernel's own limit: T*m <= WIDE_MAX_TM
    top = tk.WIDE_MAX_TM
    assert route("cuda", torch.float32, ct, samples, top, 1, 0.0) == ("pallas" if eligible
                                                                       else "xla")
    assert route("cuda", torch.float32, ct, samples, top + 1, 1, 0.0) == "xla"
    with pytest.raises(ValueError, match=f"horizon \\* m <= {top}"):
        route("cuda", torch.float32, ct, samples, top + 1, 1, 0.0, method="pallas")


def _cu_constant(name: str) -> int:
    """A constant of csrc/mppi_wide.cu, `constexpr <type> name = a * b ...;`."""
    text = (_build.CSRC / "mppi_wide.cu").read_text()
    found = re.search(rf"constexpr \w+ {name} = ([0-9 *]+);", text)
    assert found, f"csrc/mppi_wide.cu has no constant {name}"
    return math.prod(int(x) for x in found.group(1).split("*"))


@pytest.mark.parametrize("K", [1, 31, 32, 33, 128, 255, 256, 257, 511, 512, 513, 1023, 1024, 1025,
                               1152, 2047, 2048, 3071, 4096, 4097, 16384, 16385, 32768, 100000])
def test_wide_plan_fits_the_kernels_budgets(K):
    """The plan csrc/mppi_wide.cu checks, with the .cu's own constants:
    whole warps within kMaxThreads, 1, 2 or 4 samples a thread (its
    instances), tiles that carry every sample and no empty tile, and the
    block's shared memory (the nominal at kMaxTM, the reductions' kRed
    partials and a tile's weights) within kSmemMax; the module's limits are
    the .cu's."""
    assert (_cu_constant("kMaxThreads"), _cu_constant("kMaxTM")) == \
        (tk.WIDE_THREADS, tk.WIDE_MAX_TM)
    threads, spt, tiles = tk.wide_plan(K)
    tile = threads * spt
    assert threads % 32 == 0 and 32 <= threads <= tk.WIDE_THREADS and spt in (1, 2, 4)
    assert tiles * tile >= K > (tiles - 1) * tile and tiles == -(-K // 1024)
    smem = 4 * ((_cu_constant("kMaxTM") + 3) // 4 * 4 + _cu_constant("kRed") + tile)
    assert smem <= _cu_constant("kSmemMax")
    assert tk.is_narrow(K, 40, 1) == (K <= tk.MAX_K)


def test_wide_plan_at_the_slice():
    """The slice's shapes: 4096 samples in four tiles of 256 threads x 4;
    1152 in two tiles of 160 x 4, not one tile of 1024 and a ragged one;
    16384 in 16 whole tiles, 16385 in 17."""
    assert tk.wide_plan(4096) == (256, 4, 4)
    assert tk.wide_plan(2048) == (256, 4, 2)
    assert tk.wide_plan(1152) == (160, 4, 2)
    assert tk.wide_plan(16384) == (256, 4, 16)
    assert tk.wide_plan(16385) == (256, 4, 17)
    assert [tk.kernel_function(K, T, m) for K, T, m in
            ((1024, 1024, 1), (1024, 512, 2), (1025, 40, 1), (256, 513, 2), (4096, 40, 1))] == \
        ["npt_mppi", "npt_mppi", "npt_mppi_wide", "npt_mppi_wide", "npt_mppi_wide"]


@pytest.mark.parametrize("K,T,m", [(4096, 40, 1), (128, 640, 2), (16512, 12, 1)])
def test_kernel_operands_take_the_wide_sizes(K, T, m):
    """kernel_operands accepts K = 4096, T*m = 1280 and K = 16512, and
    kernel_args lays out the wide launch: one argument a parameter of
    npt_mppi_wide but the stream, the plan last, no scratch at any K."""
    name = "pendulum" if m == 1 else "unicycle"
    f = tm.pendulum_step if m == 1 else tm.unicycle_step
    n = 2 if m == 1 else 3
    ct = tm.quadratic_mppi_cost(*((QP, RP, QFP, np.zeros(2)) if name == "pendulum"
                                  else (QU, RU, QFU, GOAL_U)))
    N, iters = 2, 1
    x0s, eps = torch.zeros((N, n)), torch.zeros((iters * T * m, N, K))
    plant, _, _, ins, outs = tk.kernel_operands(f, ct, x0s, eps, torch.zeros(T * m), T=T,
                                                iters=iters, m=m, sigma=1.0)
    assert (plant.n, plant.m) == (n, m) and outs[0].shape == (N, T, m)
    args, tensors = tk.kernel_args(f, ct, x0s, eps, torch.zeros(T * m), T=T, iters=iters, m=m,
                                   sigma=1.0, lam=1.0)
    assert tk.kernel_function(K, T, m) == "npt_mppi_wide"
    assert len(args) == len(_build._SIGNATURES["npt_mppi_wide"]) - 1
    threads, spt, _ = tk.wide_plan(K)
    assert args[-2:] == (threads, spt)
    assert len(tensors) == 5 and args[10:15] == tuple(t.data_ptr() for t in tensors)


def test_kernel_operands_refuse_past_the_wide_limit():
    """T*m past WIDE_MAX_TM = 32768 (the nominal in the wide kernel's shared
    memory) and an empty sample axis are refused before any launch; the
    narrow launch keeps its own arguments."""
    ct = tm.quadratic_mppi_cost(QU, RU, QFU, GOAL_U)
    T = tk.WIDE_MAX_TM // 2 + 1
    with pytest.raises(ValueError, match="WIDE_MAX_TM = 32768"):
        tk.kernel_operands(tm.unicycle_step, ct, torch.zeros((1, 3)), torch.zeros((2 * T, 1, 4)),
                           torch.zeros(2 * T), T=T, iters=1, m=2, sigma=1.0)
    tk.kernel_operands(tm.unicycle_step, ct, torch.zeros((1, 3)),
                       torch.zeros((2 * (T - 1), 1, 4)), torch.zeros(2 * (T - 1)), T=T - 1,
                       iters=1, m=2, sigma=1.0)
    with pytest.raises(ValueError, match="1 <= K"):
        tk.kernel_operands(tm.unicycle_step, ct, torch.zeros((1, 3)), torch.zeros((8, 1, 0)),
                           torch.zeros(8), T=4, iters=1, m=2, sigma=1.0)
    args, _ = tk.kernel_args(tm.unicycle_step, ct, torch.zeros((1, 3)), torch.zeros((8, 1, 1024)),
                             torch.zeros(8), T=4, iters=1, m=2, sigma=1.0, lam=1.0)
    assert len(args) == len(_build._SIGNATURES["npt_mppi"]) - 1
    threads, spt, tc, _, resident = tk.chunk_plan(1024, 4, 2)
    assert args[-4:] == (threads, spt, tc, int(resident))
