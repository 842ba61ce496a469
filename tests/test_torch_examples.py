"""The port's examples (numpower_tpu_torch/examples/01-07) run on the CPU.

Each runs as a user would start it, in a subprocess of its own with
``--device cpu`` (06 and 07 alone: world size 1 over a FileStore in a
temporary directory), and must exit 0 within its timeout and print the
quantities its JAX twin in examples/ prints. They never import jax.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "numpower_tpu_torch" / "examples"
TIMEOUT_S = 240
# a line each example must print (the quantities of its JAX twin)
PRINTS = {
    "01_ndarray_quickstart.py": ("chained:", "cholesky:", "reloaded:", "conv out shape: (8, 8)"),
    "02_mpc_flagship.py": ("FISTA residual", "state-constrained residual",
                           "tick controls shape: (512, 4)"),
    "03_nonlinear_trajopt.py": ("iLQR cartpole", "AL-iLQR pendulum", "MPPI unicycle"),
    "04_output_feedback_loop.py": ("16 closed loops, 80 ticks", "velocity estimate error",
                                   "controls respected the box"),
    "05_estimation.py": ("filter err", "smoother err", "EKF pendulum", "UKF pendulum",
                         "PF pendulum", "batched KF+RTS"),
    "06_horizon_sharded.py": ("sharded Riccati T=64 over 1 ranks",
                              "pipelined rollout N=13 T=123: full trajectories (13, 124, 2)"),
    "07_sharded_sampling.py": ("mesh: {'data': 1, 'model': 1}", "MPPI: mean cost", "PF: log-lik"),
}


def test_every_jax_example_has_a_twin():
    jax_examples = sorted(p.name for p in (ROOT / "examples").glob("0*.py"))
    assert sorted(PRINTS) == jax_examples
    assert sorted(p.name for p in EXAMPLES.glob("0*.py")) == jax_examples


@pytest.mark.parametrize("name", sorted(PRINTS))
def test_example_runs_on_the_cpu(name, tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = str(ROOT)
    env["TMPDIR"] = str(tmp_path)
    code = ("import runpy, sys; sys.argv = [sys.argv[1], '--device', 'cpu']; "
            "runpy.run_path(sys.argv[0], run_name='__main__'); "
            "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'numpower_tpu')]")
    r = subprocess.run([sys.executable, "-c", code, str(EXAMPLES / name)], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=TIMEOUT_S)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    for line in PRINTS[name]:
        assert line in r.stdout, (line, r.stdout)
