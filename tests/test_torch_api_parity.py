"""Three repairs of the port's API against the JAX package's, each beside
the JAX call on the same numpy inputs (CPU):

- the sampling entry points take the JAX name ``key=`` for their
  ``torch.Generator`` (and the layout functions ``sigma_arr=``): each call
  with ``key=`` gives the result of ``generator=`` on the same seed, the
  shapes of the JAX call with its key, and passing both raises TypeError;
- ``models.estimation.linearize`` and ``models.mhe.solve_qp_osqp`` exist, as
  in the JAX modules, and agree with the JAX functions;
- ``parallel.make_mesh(devices=...)`` takes one device for each rank of the
  group (here a one-rank gloo group over a FileStore), as JAX's takes a
  device list, and refuses a list of another length.

The draws of the two packages differ (a torch.Generator against a JAX
key), so a sampling call is held to its own generator= call bit for bit
and to the JAX call's shapes; the solvers' values against JAX's on the same
draws are in tests/test_torch_{mppi,particle,parallel}.py.
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import numpower_tpu.models as jm  # noqa: E402
import numpower_tpu_torch.models as tm  # noqa: E402
from numpower_tpu.kernels import mppi as jk  # noqa: E402
from numpower_tpu.models import estimation as jest  # noqa: E402
from numpower_tpu.models import mhe as jmhe  # noqa: E402
from numpower_tpu.parallel import mesh as jmesh  # noqa: E402
from numpower_tpu.parallel import sampling as jsampling  # noqa: E402
from numpower_tpu_torch.kernels import mppi as tk  # noqa: E402
from numpower_tpu_torch.models import estimation as t_est  # noqa: E402
from numpower_tpu_torch.models import mhe as tmhe  # noqa: E402
from numpower_tpu_torch.parallel import make_mesh  # noqa: E402
from numpower_tpu_torch.parallel import sampling as tsampling  # noqa: E402

QM, RM, QFM = (np.diag([1.0, 0.1]).astype(np.float32), np.eye(1, dtype=np.float32) * 0.01,
               np.diag([10.0, 1.0]).astype(np.float32))
MPPI = dict(samples=16, iters=2, m=1)
PF = dict(n_particles=32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _equal(a, b):
    """Two results (tensors, named tuples or tuples of them) equal element
    for element."""
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


def _shapes(r):
    if isinstance(r, (tuple, list)):
        return tuple(_shapes(x) for x in r)
    return tuple(getattr(r, "shape", ()))


@pytest.fixture(scope="module")
def group1(tmp_path_factory):
    """The default process group of this process at world size 1."""
    store = dist.FileStore(str(tmp_path_factory.mktemp("parity") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    yield
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def meshes(group1):
    return jmesh.make_mesh((1, 1), devices=jax.devices()[:1]), make_mesh((1, 1))


def _costs():
    cj = jm.quadratic_mppi_cost(jnp.asarray(QM), jnp.asarray(RM), jnp.asarray(QFM), jnp.zeros(2))
    ct = tm.quadratic_mppi_cost(QM, RM, QFM, np.zeros(2, np.float32))
    return cj, ct


def _pf_problem(batched):
    rng = np.random.default_rng(1)
    Q, R, P0 = (np.eye(2, dtype=np.float32) * 1e-2, np.eye(1, dtype=np.float32) * 1e-2,
                np.eye(2, dtype=np.float32) * 0.1)
    shape = (3, 5) if batched else (5,)
    ys = rng.standard_normal(shape + (1,)).astype(np.float32)
    us = (0.1 * rng.standard_normal(shape + (1,))).astype(np.float32)
    x0 = (0.3 * rng.standard_normal((3, 2) if batched else (2,))).astype(np.float32)
    return Q, R, x0, P0, ys, us


def _h_jax(x):
    return x[:1]


_h_port = functools.partial(tm.first_components, k=1)


def call_mppi_solve(kw, meshes=None):
    cj, ct = _costs()
    x0 = np.array([0.5, 0.0], np.float32)
    if "jax" in kw:
        return jm.mppi_solve(jm.pendulum_step, jnp.asarray(x0), cj, 4, key=kw["jax"], **MPPI)
    return tm.mppi_solve(tm.pendulum_step, _t(x0), ct, 4, **kw, **MPPI)


def call_mppi_step(kw, meshes=None):
    cj, ct = _costs()
    plan, x0 = np.zeros((4, 1), np.float32), np.array([0.5, 0.0], np.float32)
    if "jax" in kw:
        return jm.mppi_step(jm.pendulum_step, jnp.asarray(plan), jnp.asarray(x0), cj,
                            key=kw["jax"], **MPPI)
    return tm.mppi_step(tm.pendulum_step, _t(plan), _t(x0), ct, **kw, **MPPI)


def call_mppi_solve_batched(kw, meshes=None):
    cj, ct = _costs()
    x0s = (0.3 * np.random.default_rng(2).standard_normal((3, 2))).astype(np.float32)
    if "jax" in kw:
        return jm.mppi_solve_batched(jm.pendulum_step, jnp.asarray(x0s), cj, 4, key=kw["jax"],
                                     **MPPI)
    return tm.mppi_solve_batched(tm.pendulum_step, _t(x0s), ct, 4, **kw, **MPPI)


def call_particle_filter(kw, meshes=None):
    Q, R, x0, P0, ys, us = _pf_problem(False)
    if "jax" in kw:
        return jm.particle_filter(jm.pendulum_step, _h_jax, *(jnp.asarray(a) for a in (
            Q, R, x0, P0, ys, us)), key=kw["jax"], **PF)
    return tm.particle_filter(tm.pendulum_step, _h_port, *(_t(a) for a in (Q, R, x0, P0, ys, us)),
                              **kw, **PF)


def call_particle_filter_batched(kw, meshes=None):
    Q, R, x0s, P0, yss, uss = _pf_problem(True)
    if "jax" in kw:
        return jm.particle_filter_batched(jm.pendulum_step, _h_jax, *(jnp.asarray(a) for a in (
            Q, R, x0s, P0, yss, uss)), key=kw["jax"], **PF)
    return tm.particle_filter_batched(tm.pendulum_step, _h_port, *(_t(a) for a in (
        Q, R, x0s, P0, yss, uss)), **kw, **PF)


def call_simulate_closed_loop(kw, meshes=None):
    A, B = jm.double_integrator(0.1)
    x0s = np.random.default_rng(3).standard_normal((3, 2)).astype(np.float32)
    if "jax" in kw:
        A_j, B_j = jnp.asarray(A), jnp.asarray(B)
        return jm.simulate_closed_loop(lambda x, u: A_j @ x + B_j @ u,
                                       lambda s, x, t: (-0.5 * x[:, :1], s), 0,
                                       jnp.asarray(x0s), 4, key=kw["jax"], w_std=0.1)
    A_t, B_t = _t(A), _t(B)
    return tm.simulate_closed_loop(lambda x, u: x @ A_t.T + u @ B_t.T,
                                   lambda s, x, t: (-0.5 * x[:, :1], s), 0, _t(x0s), 4,
                                   **kw, w_std=0.1)


def call_mppi_solve_dp(kw, meshes):
    cj, ct = _costs()
    x0s = (0.3 * np.random.default_rng(2).standard_normal((2, 2))).astype(np.float32)
    if "jax" in kw:
        return jsampling.mppi_solve_dp(jm.pendulum_step, jnp.asarray(x0s), cj, 4, key=kw["jax"],
                                       mesh=meshes[0], **MPPI)
    return tsampling.mppi_solve_dp(tm.pendulum_step, _t(x0s), ct, 4, **kw,
                                   mesh=meshes[1], **MPPI)


def call_particle_filter_dp(kw, meshes):
    Q, R, x0, P0, ys, us = _pf_problem(False)
    if "jax" in kw:
        return jsampling.particle_filter_dp(jm.pendulum_step, _h_jax, *(jnp.asarray(a) for a in (
            Q, R, x0, P0, ys, us)), key=kw["jax"], mesh=meshes[0], **PF)
    return tsampling.particle_filter_dp(tm.pendulum_step, _h_port, *(_t(a) for a in (
        Q, R, x0, P0, ys, us)), **kw, mesh=meshes[1], **PF)


def _layout(fn_name, kw, meshes=None):
    shape = dict(N=3, iters=2, T=4, m=2, K=8)
    if "jax" in kw:
        return getattr(jk, fn_name)(key=kw["jax"], **shape, sigma_arr=jnp.asarray([0.5, 0.7]))
    return getattr(tk, fn_name)(**kw, **shape, sigma_arr=(0.5, 0.7))


call_eps_kernel_layout = functools.partial(_layout, "eps_kernel_layout")
call_eps_direct_layout = functools.partial(_layout, "eps_direct_layout")

ENTRIES = {name[len("call_"):]: fn for name, fn in globals().items() if name.startswith("call_")}
NEEDS_MESH = {"mppi_solve_dp", "particle_filter_dp"}


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_key_is_the_generator_by_the_jax_name(entry, request):
    meshes = request.getfixturevalue("meshes") if entry in NEEDS_MESH else None
    call = ENTRIES[entry]
    by_key = call({"key": _gen(0)}, meshes)
    assert _equal(by_key, call({"generator": _gen(0)}, meshes))
    assert not _equal(by_key, call({"key": _gen(1)}, meshes))  # the key is the stream
    assert _shapes(by_key) == _shapes(call({"jax": jax.random.key(0)}, meshes))
    with pytest.raises(TypeError):
        call({"generator": _gen(0), "key": _gen(0)}, meshes)


def test_layouts_take_sigma_or_sigma_arr_not_both():
    shape = dict(N=2, iters=1, T=2, m=1, K=4)
    a = tk.eps_kernel_layout(_gen(0), **shape, sigma=0.5)
    assert torch.equal(a, tk.eps_kernel_layout(key=_gen(0), **shape, sigma_arr=0.5))
    with pytest.raises(TypeError):
        tk.eps_kernel_layout(_gen(0), **shape, sigma=0.5, sigma_arr=0.5)
    with pytest.raises(TypeError, match="sigma"):
        tk.eps_direct_layout(key=_gen(0), **shape)


def test_estimation_linearize_is_the_jax_modules_name():
    from numpower_tpu_torch.models import rollout

    assert t_est.linearize is rollout.linearize
    x, u = np.array([0.3, -0.2], np.float32), np.array([0.1], np.float32)
    A_j, B_j = jest.linearize(jm.pendulum_step, jnp.asarray(x), jnp.asarray(u))
    A_t, B_t = t_est.linearize(tm.pendulum_step, _t(x), _t(u))
    np.testing.assert_allclose(A_t.numpy(), np.asarray(A_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(B_t.numpy(), np.asarray(B_j), rtol=1e-5, atol=1e-6)


def test_mhe_solve_qp_osqp_is_the_jax_modules_name():
    from numpower_tpu_torch.models import admm

    assert tmhe.solve_qp_osqp is admm.solve_qp_osqp
    rng = np.random.default_rng(4)
    M = rng.standard_normal((4, 4)).astype(np.float32)
    H = (M @ M.T + 4 * np.eye(4)).astype(np.float32)
    g = rng.standard_normal(4).astype(np.float32)
    A = np.eye(4, dtype=np.float32)
    lo, hi = -0.3 * np.ones(4, np.float32), 0.3 * np.ones(4, np.float32)
    want = jmhe.solve_qp_osqp(*(jnp.asarray(a) for a in (H, g, A, lo, hi)), iters=200)
    got = tmhe.solve_qp_osqp(*(_t(a) for a in (H, g, A, lo, hi)), iters=200)
    np.testing.assert_allclose(got.U.numpy(), np.asarray(want.U), rtol=0, atol=1e-4)


def test_make_mesh_takes_a_device_for_each_rank(group1):
    want = jmesh.make_mesh((1, 1), devices=jax.devices()[:1])
    mesh = make_mesh((1, 1), devices=[torch.device("cpu")])
    assert mesh.shape == tuple(want.devices.shape) == (1, 1)
    assert mesh.axis_names == tuple(want.axis_names)
    assert mesh.device == torch.device("cpu")
    assert make_mesh(devices=["cpu"]).device == torch.device("cpu")
    with pytest.raises(ValueError, match="one device for each rank"):
        make_mesh((1, 1), devices=["cpu", "cpu"])
    with pytest.raises(TypeError):
        make_mesh((1, 1), device="cpu", devices=["cpu"])
