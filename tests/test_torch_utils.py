"""numpower_tpu_torch.utils (checkpoint, profiler, flops, config) against the
JAX package's utils (CPU).

Checkpoints: the .npz layout is the JAX package's (leaf_i plus __treedef__),
so a file written by either package loads into the other equal, with
``like`` giving the structure: a tree holding a dict with unsorted keys (JAX
numbers the leaves in sorted-key order), each package's MPCState (its two
leaves U_prev and tick, the tick an int32 scalar). The directory route is
the port's own (torch.save of the CPU leaves). The profiler tests are the
twins of tests/test_controller_utils.py:69-85 plus a trace written on the
CPU. The cost model's logical FLOPs and bytes equal JAX's at three shapes
(the same work); its peaks are the H100's for the H100's name and None for
any other device and the CPU.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from numpower_tpu_torch.kernels.precision import TENSOR_PASSES
from numpower_tpu_torch.models.mpc import MPCController, MPCState
from numpower_tpu_torch.utils import checkpoint, config, flops, profiler

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from numpower_tpu.models.mpc import MPCState as JaxState  # noqa: E402
from numpower_tpu.utils import checkpoint as jax_checkpoint  # noqa: E402
from numpower_tpu.utils import config as jax_config  # noqa: E402
from numpower_tpu.utils import flops as jax_flops  # noqa: E402

H100_NAME = "NVIDIA H100 80GB HBM3"


def _tree(rng):
    """A tree whose dict keys are not in sorted order at any level."""
    return {"zeta": rng.standard_normal((3, 2)).astype(np.float32),
            "alpha": {"y": np.arange(4, dtype=np.int32), "b": None,
                      "a": (rng.standard_normal(5).astype(np.float32), np.float32(2.5))},
            "mid": [np.ones((2, 2), np.float32)]}


def _torch_tree(tree):
    return {"zeta": torch.from_numpy(tree["zeta"]),
            "alpha": {"y": torch.from_numpy(tree["alpha"]["y"]), "b": None,
                      "a": (torch.from_numpy(tree["alpha"]["a"][0]),
                            torch.tensor(tree["alpha"]["a"][1]))},
            "mid": [torch.from_numpy(tree["mid"][0])]}


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _equal_trees(got, want):
    got_leaves = checkpoint.tree_leaves(got)
    want_leaves = jax.tree_util.tree_leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_array_equal(g, np.asarray(w))


def test_leaf_order_is_jax_order():
    tree = _tree(np.random.default_rng(0))
    _equal_trees(_torch_tree(tree), _jax_tree(tree))
    assert [x.shape for x in checkpoint.tree_leaves(_torch_tree(tree))] == \
        [x.shape for x in jax.tree_util.tree_leaves(_jax_tree(tree))]


def test_npz_written_by_jax_loads_into_the_port(tmp_path):
    tree = _tree(np.random.default_rng(1))
    path = str(tmp_path / "j.npz")
    jax_checkpoint.save_checkpoint(path, _jax_tree(tree), {"step": 3})
    like = _torch_tree(_tree(np.random.default_rng(99)))
    got = checkpoint.load_checkpoint(path, like=like)
    assert list(got) == list(like) and list(got["alpha"]) == list(like["alpha"])
    assert got["alpha"]["b"] is None and isinstance(got["mid"], list)
    _equal_trees(got, _jax_tree(tree))
    assert got["alpha"]["y"].dtype == torch.int32 and got["zeta"].device.type == "cpu"


def test_npz_written_by_the_port_loads_into_jax(tmp_path):
    tree = _tree(np.random.default_rng(2))
    path = str(tmp_path / "t.npz")
    checkpoint.save_checkpoint(path, _torch_tree(tree), {"step": 4})
    with np.load(path) as data:
        header = json.loads(bytes(data["__treedef__"]).decode())
        assert sorted(data.files) == sorted([f"leaf_{i}" for i in range(5)] + ["__treedef__"])
    assert header["meta"] == {"step": 4}
    got = jax_checkpoint.load_checkpoint(path, like=_jax_tree(_tree(np.random.default_rng(5))))
    _equal_trees(_torch_tree(tree), got)


def test_mpc_state_is_a_tree_of_two_leaves():
    U = torch.randn(4, 6)
    state = MPCState(U_prev=U, tick=7)
    leaves, spec = torch.utils._pytree.tree_flatten(state)
    assert len(leaves) == 2 and leaves[0] is U
    assert leaves[1].dtype == torch.int32 and leaves[1].ndim == 0 and int(leaves[1]) == 7
    back = torch.utils._pytree.tree_unflatten(leaves, spec)
    assert isinstance(back, MPCState) and back.tick == 7 and isinstance(back.tick, int)
    doubled = torch.utils._pytree.tree_map(lambda x: x * 2, state)
    assert doubled.tick == 14 and torch.equal(doubled.U_prev, 2 * U)


def test_mpc_state_checkpoints_cross_between_the_packages(tmp_path):
    """JAX's MPCState file into the port's state and the other way round,
    the tick an int32 scalar in both files."""
    rng = np.random.default_rng(3)
    U = rng.standard_normal((8, 6)).astype(np.float32)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jax_checkpoint.save_checkpoint(jpath, JaxState(U_prev=jnp.asarray(U),
                                                   tick=jnp.asarray(5, jnp.int32)))
    ctrl = MPCController(np.eye(2, dtype=np.float32), np.ones((2, 1), np.float32),
                         np.eye(2, dtype=np.float32), np.eye(1, dtype=np.float32),
                         np.eye(2, dtype=np.float32), horizon=6, u_lo=-1, u_hi=1, device="cpu")
    like = ctrl.init(8)
    got = checkpoint.load_checkpoint(jpath, like=like)
    assert isinstance(got, MPCState) and got.tick == 5
    assert got.U_prev.device.type == "cpu" and np.array_equal(got.U_prev.numpy(), U)
    checkpoint.save_checkpoint(tpath, MPCState(U_prev=torch.from_numpy(U), tick=9))
    with np.load(tpath) as data:
        assert data["leaf_1"].dtype == np.int32 and data["leaf_1"].shape == ()
    back = jax_checkpoint.load_checkpoint(
        tpath, like=JaxState(U_prev=jnp.zeros((8, 6)), tick=jnp.asarray(0, jnp.int32)))
    assert isinstance(back, JaxState) and back.tick.dtype == jnp.int32 and int(back.tick) == 9
    np.testing.assert_array_equal(np.asarray(back.U_prev), U)
    # a loaded state serves the next tick
    u0, nxt = ctrl.step(got, torch.zeros((8, 2)))
    assert nxt.tick == 6 and u0.shape == (8, 1)


def test_directory_route_round_trip(tmp_path):
    tree = _torch_tree(_tree(np.random.default_rng(4)))
    state = MPCState(U_prev=torch.randn(3, 4), tick=2)
    path = str(tmp_path / "ckpt")
    checkpoint.save_checkpoint(path, {"tree": tree, "state": state}, {"note": "x"})
    assert os.listdir(path) == ["checkpoint.pt"]
    like = {"tree": _torch_tree(_tree(np.random.default_rng(6))),
            "state": MPCState(U_prev=torch.zeros(3, 4), tick=0)}
    got = checkpoint.load_checkpoint(path, like=like)
    assert got["state"].tick == 2 and torch.equal(got["state"].U_prev, state.U_prev)
    _equal_trees(got["tree"], _jax_tree(_tree(np.random.default_rng(4))))
    saved = torch.load(os.path.join(path, "checkpoint.pt"), weights_only=True)
    assert json.loads(saved["header"])["meta"] == {"note": "x"}
    assert all(x.device.type == "cpu" for x in saved["leaves"])


def test_load_without_like_goes_to_the_card(tmp_path):
    """Without `like` the leaves go to the card (utils.default_device): on a
    machine without CUDA that raises rather than falling back to the CPU."""
    path = str(tmp_path / "t.npz")
    checkpoint.save_checkpoint(path, {"a": torch.ones(2)})
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            checkpoint.load_checkpoint(path)
    with pytest.raises(ValueError):
        checkpoint.load_checkpoint(path, like={"a": torch.ones(2), "b": torch.ones(1)})


# -- profiler -------------------------------------------------------------------------------


def test_timer_phases():
    t = profiler.Timer()
    with t.phase("a"):
        pass
    with t.phase("a"):
        pass
    s = t.summary()
    assert s["a"]["count"] == 2
    assert "a:" in t.report()


def test_time_compiled_returns_positive():
    x = torch.ones((64, 64))
    dt = profiler.time_compiled(lambda x: x * 2 + 1, x, reps=2, inner=(2, 12))
    assert dt > 0
    med, iqr = profiler.time_compiled(lambda x: (x @ x, x), x, reps=3, inner=(1, 3),
                                      return_stats=True)
    assert med > 0 and iqr >= 0


def test_trace_and_annotate_write_a_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with profiler.trace(log_dir):
        with profiler.annotate("nptpu_solve_region"):
            torch.ones((32, 32)) @ torch.ones((32, 32))
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(log_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "nptpu_solve_region" for e in events)


# -- flops ----------------------------------------------------------------------------------

QP_SHAPES = [(4096, 12, 120, 40, 20), (256, 4, 32, 10, 0), (1003, 2, 7, 30, 25)]
COSTS = {
    "kalman_batched_cost": [(4096, 50, 2, 1), (1003, 50, 4, 2), (1, 7, 12, 3)],
    "mppi_batched_cost": [(256, 256, 8, 40, 1), (64, 128, 4, 30, 2), (1, 1, 1, 1, 1)],
    "rts_batched_cost": [(4096, 50, 2), (1003, 30, 4), (1, 2, 12)],
    "riccati_associative_cost": [(4096, 12), (30, 2), (1, 4)],
    "kalman_associative_cost": [(4096, 2), (37, 4), (1, 12)],
    "riccati_fused_cost": [(4096, 30, 12, 4), (1003, 30, 12, 4), (1, 1, 2, 1)],
    "ilqr_backward_cost": [(256, 50, 4, 1), (4096, 40, 2, 1), (1, 200, 6, 2)],
    "particle_filter_cost": [(256, 1024, 50, 2, 1), (1, 65536, 50, 2, 1), (3, 7, 5, 4, 2)],
    "ekf_batched_cost": [(1024, 50, 2, 1), (1024, 50, 3, 2), (1, 5, 6, 3)],
    "ukf_batched_cost": [(1024, 50, 2, 1), (1024, 50, 6, 3), (1, 5, 3, 2)],
}


@pytest.mark.parametrize("name", ["fista_mpc_cost", "admm_mpc_cost"])
@pytest.mark.parametrize("shape", QP_SHAPES)
def test_qp_costs_count_jax_logical_work(name, shape):
    got, want = getattr(flops, name)(*shape), getattr(jax_flops, name)(*shape)
    assert got.flops_logical == want.flops_logical
    assert got.flops_padded >= got.flops_logical and got.flops_weighted >= got.flops_padded
    assert 0.0 <= got.padding_waste < 1.0


@pytest.mark.parametrize("name", list(COSTS))
@pytest.mark.parametrize("k", [0, 1, 2])
def test_roofline_costs_equal_jax(name, k):
    shape = COSTS[name][k]
    got, want = getattr(flops, name)(*shape), getattr(jax_flops, name)(*shape)
    assert got.flops == want.flops and got.bytes_moved == want.bytes_moved


@pytest.mark.parametrize("shape", [(256, 1024, 50, 2), (1, 65536, 50, 2), (3, 7, 5, 4)])
def test_pf_resample_cost_counts_jax_logical_work(shape):
    got, want = flops.pf_resample_cost(*shape), jax_flops.pf_resample_cost(*shape)
    assert got.flops_logical == want.flops_logical == got.flops_padded


def test_qp_padding_and_passes_are_the_tensor_core_tile():
    """N rounds up to the tile's 32 scenarios and d to 128; coarse products
    1 pass, the tail, residual and fold "highest" (6)."""
    c = flops.fista_mpc_cost(N=33, n=2, d=100, iters=10, coarse_iters=4)
    it_p = 2 * 64 * 128 * 128
    fold = 2 * 64 * 2 * 100
    assert c.flops_padded == fold + 10 * it_p + it_p
    assert c.flops_weighted == 6 * fold + 4 * it_p + 6 * 6 * it_p + 6 * it_p


def test_passes_equal_chip_smoke_and_the_kernels():
    assert flops.PASSES == jax_flops.PASSES
    assert flops.PASSES["bf16"] == TENSOR_PASSES["coarse"]
    for cls in ("bf16x3", "bf16x4", "highest"):
        assert flops.PASSES[cls] == TENSOR_PASSES[cls]
        assert chip_smoke.boxqp_passes(0, 1, cls) == flops.PASSES[cls]
        assert chip_smoke.boxqp_passes(7, 5, cls) == \
            7 * flops.PASSES["bf16"] + 5 * flops.PASSES[cls]
    assert chip_smoke.boxqp_passes(3, 0) == 3 * flops.PASSES["bf16"]


def test_peaks_are_the_h100_data_sheet_and_none_elsewhere():
    assert flops.peak_tflops(H100_NAME) == 989.0
    assert flops.vpu_peak_tflops(H100_NAME) == 67.0
    assert flops.peak_hbm_gbps(H100_NAME) == 3350.0
    for dev in ("cpu", torch.device("cpu"), "NVIDIA A100-SXM4-80GB", "TPU v5 lite"):
        assert flops.peak_tflops(dev) is None and flops.peak_hbm_gbps(dev) is None
        assert flops.vpu_peak_tflops(dev) is None
    if not torch.cuda.is_available():
        assert flops.peak_tflops() is None and flops.peak_hbm_gbps() is None
    peaks = flops.H100_SXM
    assert (chip_smoke.HBM_BYTES_PER_S, chip_smoke.FP32_FLOP_PER_S,
            chip_smoke.BF16_TENSOR_FLOP_PER_S) == (peaks.hbm_gbps * 1e9, peaks.fp32_tflops * 1e12,
                                                   peaks.bf16_tflops * 1e12)


def test_reports_name_the_bound_or_say_no_peak():
    cost = flops.riccati_fused_cost(4096, 30, 12, 4)
    assert "no H100 peak" in flops.roofline_report("k5", cost, 1e-3, "cpu")
    line = flops.roofline_report("k5", cost, 1e-3, H100_NAME)
    assert "operations-bound" in line and "% of roofline" in line
    qp = flops.fista_mpc_cost(4096, 12, 120, 40, 20)
    assert "MFU n/a" in flops.mfu_report("k2", qp, 1e-3, None)
    assert "MFU" in flops.mfu_report("k2", qp, 1e-3, flops.peak_tflops(H100_NAME))


def test_k5_operation_count_is_the_cost_model():
    N, T, n, m = 4096, 30, 12, 4
    assert flops.riccati_fused_cost(N, T, n, m).flops == \
        N * T * (4 * n ** 3 + 4 * m * n * n + 4 * m * m * n + m ** 3)


# -- config ---------------------------------------------------------------------------------


def test_config_has_the_jax_fields():
    got = [f.name for f in dataclasses.fields(config.Config)]
    want = [f.name for f in dataclasses.fields(jax_config.Config)]
    assert got == want
    c, j = config.Config(), jax_config.Config()
    for name in got:
        if name != "default_dtype":
            assert getattr(c, name) == getattr(j, name), name
    assert c.default_dtype is torch.float32 and config.default_dtype() is torch.float32


def test_config_env_switches():
    code = ("from numpower_tpu_torch.utils.config import config; "
            "print(config.buffer_debug, config.check_leaks)")
    env = {k: v for k, v in os.environ.items() if k not in ("NPTPU_BUFFER_DEBUG", "NPTPU_VCHECK")}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root
    off = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120, check=True).stdout.split()
    on = subprocess.run([sys.executable, "-c", code],
                        env={**env, "NPTPU_BUFFER_DEBUG": "1", "NPTPU_VCHECK": "1"},
                        capture_output=True, text=True, timeout=120, check=True).stdout.split()
    assert off == ["False", "False"] and on == ["True", "True"]


def test_mesh_reads_the_config(monkeypatch):
    """make_mesh takes its default shape and axis names from the config, as
    the JAX package's does."""
    import torch.distributed as dist

    from numpower_tpu_torch.parallel import make_mesh

    monkeypatch.setattr(config.config, "data_axis", "scen")
    monkeypatch.setattr(config.config, "mesh_shape", (1, 1))
    store = dist.HashStore()
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        mesh = make_mesh()
        assert mesh.shape == (1, 1) and mesh.axis_names == ("scen", "model")
    finally:
        dist.destroy_process_group()
