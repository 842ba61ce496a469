"""Build and load the port's CUDA kernels.

Every ``numpower_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` per source, all started together, and the objects
are linked into one shared library with a plain C interface, at first use,
into ``build/numpower_tpu_torch/`` at the repository root. The library's name
carries a hash of the sources and flags, so an edited source builds anew and
an unchanged one loads the library already there. It is loaded with
``ctypes``: every pointer and the stream are ``ctypes.c_void_p``, and every
launch function returns ``cudaGetLastError()``, which :func:`check` turns into
an exception.

A missing ``nvcc`` or a failed build raises with the compiler's output; there
is no fallback. Each build writes the compiler's output (``-Xptxas -v``:
registers, shared memory and spills per kernel) beside the library, as
``<library>.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "numpower_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Limits of the box-QP kernels (csrc/boxqp_tile.cuh). TILE_D (kMaxD, kTileD)
# is the rows of the product one block owns: d <= TILE_D takes the narrow
# tile, whose block holds the matrix's three bf16 splits, two buffers of the
# operand's and a chunk of the fold with x0 in 164 KiB of the 227 KiB of
# shared memory a block may have. TILE_D < d <= MAX_D (kMaxWideD, the JAX
# package's VMEM bound of d = 1024) takes the wide tile: a cluster of
# ceil(d / TILE_D) blocks (at most 8, the portable cluster size), the matrix
# streamed from device memory. The state dimension n of the in-kernel g / c
# formation has no bound: the kernels stage and sum the (n, d) fold
# FOLD_ROWS (kFoldRows) rows at a time, in order.
TILE_D = 128
MAX_D = 1024
FOLD_ROWS = 32

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    # Ht, W, x0, U0, lipschitz, U, resid, N, n, d, iters, coarse, lo, hi, tail_prec,
    # g_prec, stream
    "npt_fista_mpc_res": (_P,) * 7 + (_I,) * 5 + (_F, _F, _I, _I, _P),
    # rMt, Wc, x0, U0, rho, z, rp, rd, N, n, d, iters, coarse, lo, hi, alpha, form,
    # c_prec, stream
    "npt_admm_mpc_res": (_P,) * 8 + (_I,) * 5 + (_F, _F, _F, _I, _I, _P),
    # Ht, W, x0, lipschitz, U, g, N, n, d, iters, coarse, lo, hi, stream
    "npt_fista_mpc": (_P,) * 6 + (_I,) * 5 + (_F, _F, _P),
    # rMt, W, x0, rho, z, y, g, N, n, d, iters, coarse, lo, hi, alpha, stream
    "npt_admm_mpc": (_P,) * 7 + (_I,) * 5 + (_F, _F, _F, _P),
    # a, L, N, n, stream
    "npt_cholesky_batched": (_P, _P, _I, _I, _P),
    # a, b, x, N, n, r, stream
    "npt_psd_solve_batched": (_P, _P, _P, _I, _I, _I, _P),
    # As, Bs, Q, R, QF, Ks, P0, N, n, m, T, stream
    "npt_riccati_fused": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # Ht, g, U0, lipschitz, U, N, d, iters, coarse, lo, hi, stream
    "npt_fista_boxqp": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P),
    # rMt, g, U0, rho, z, y, N, d, iters, coarse, lo, hi, alpha, stream
    "npt_admm_boxqp": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _P),
    # As, Bs, lxs, lus, luud, lxx, luu_reg, lxT, lxxT, ks, Ks, N, n, m, T, work, stream
    "npt_ilqr_backward": (_P,) * 11 + (_I, _I, _I, _I, _P),
    # the wide K7 (csrc/ilqr_backward_wide.cu): npt_ilqr_backward's arguments with
    # its device workspace (or null) and As's and Bs's element strides (scenario,
    # stage, row, column) before the stream
    "npt_ilqr_backward_wide": (_P,) * 11 + (_I, _I, _I, _I, _P) + (_L,) * 8 + (_P,),
    # plant, 8 plant parameters, Q, R, QF, goal, alphas, x0s, xs_nom, us_nom, ks, Ks,
    # us, xs, costs, N, T, A, xs_rows, stream
    "npt_ilqr_forward": (_I,) + (_F,) * 8 + (_P,) * 13 + (_I, _I, _I, _I, _P),
    # A, C, W, invL, cst, x0s, ys, us, xs_f, xs_p, ll, N, T, n, p, stream
    "npt_kalman_mean": (_P,) * 11 + (_I, _I, _I, _I, _P),
    # G, es, x_last, xs, N, T, n, stream
    "npt_rts_mean": (_P,) * 4 + (_I, _I, _I, _P),
    # the wide forms (csrc/kalman_wide.cu): the narrow ones' arguments with a
    # device workspace after the outputs
    "npt_kalman_mean_wide": (_P,) * 12 + (_I, _I, _I, _I, _P),
    "npt_rts_mean_wide": (_P,) * 5 + (_I, _I, _I, _P),
    # plant, 8 plant parameters, measure, p, Q, R, P0, x0s, yss, uss, xs_f, xs_p,
    # Ps_f, Ps_p, ll, B, T, stream
    "npt_ekf": (_I,) + (_F,) * 8 + (_I, _I) + (_P,) * 11 + (_I, _I, _P),
    # as npt_ekf, with wm0, wmi, wc0, wci, c_half, jitter after p
    "npt_ukf": (_I,) + (_F,) * 8 + (_I, _I) + (_F,) * 6 + (_P,) * 11 + (_I, _I, _P),
    # plant, 8 plant parameters, consts (host), x0s, eps, us0, us, ess, N, K, T, iters,
    # lam, inv_lam, clip, lo, hi, threads, spt, Tc, resident, stream
    "npt_mppi": (_I,) + (_F,) * 8 + (_P,) * 6 + (_I,) * 4 + (_F, _F, _I, _F, _F) + (_I,) * 4
                + (_P,),
    # the wide K13 (csrc/mppi_wide.cu): plant, 8 plant parameters, consts (host), x0s,
    # eps, us0, us, ess, N, K, T, iters, lam, inv_lam, clip, lo, hi, threads, spt, stream
    "npt_mppi_wide": (_I,) + (_F,) * 8 + (_P,) * 6 + (_I,) * 4 + (_F, _F, _I, _F, _F)
                     + (_I,) * 2 + (_P,),
    # parts, m, out, B, N, n, stream
    "npt_resample_systematic": (_P, _P, _P, _I, _I, _I, _P),
    # n, d
    "npt_boxqp_wide_clusters": (_I, _I),
}
# The wide entries take the arguments of their narrow ones: the box-QP
# kernels' with the matrix as the wide tile's split operand
# (kernels/boxqp_fista._wide_operand); K5's, K6a's and K6b's past n = 16
# (csrc/riccati_wide.cu, cholesky_wide.cu).
for _name in ("npt_fista_mpc_res", "npt_fista_boxqp", "npt_fista_mpc", "npt_admm_mpc_res",
              "npt_admm_boxqp", "npt_admm_mpc", "npt_riccati_fused", "npt_cholesky_batched",
              "npt_psd_solve_batched"):
    _SIGNATURES[f"{_name}_wide"] = _SIGNATURES[_name]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for path in candidates:
        if path.is_file():
            return str(path)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH, /usr/local/cuda/bin): "
        "the CUDA kernels of numpower_tpu_torch cannot be built")


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"libnumpower_tpu_torch_{digest.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> tuple[list[int], str]:
    """Run the commands side by side; their exit codes and one log of all."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    log = "".join(f"$ {' '.join(cmd)}\n{out}" for cmd, out in zip(cmds, outs))
    return [proc.returncode for proc in procs], log


def build() -> Path:
    """Compile the sources unless the library for their hash exists."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in srcs]
    compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for obj, src in zip(objs, srcs)]
    link = [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp), *map(str, objs)]
    try:
        codes, log = _run_all(compiles)
        if not any(codes):
            link_codes, link_log = _run_all([link])
            codes, log = codes + link_codes, log + link_log
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    if any(codes):
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (exit codes {codes}):\n{log}")
    out.with_suffix(".so.log").write_text(log)
    os.replace(tmp, out)  # atomic: a concurrent build never loads a half-written file
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built at the first call."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.npt_error_string.argtypes = (ctypes.c_int,)
    lib.npt_error_string.restype = ctypes.c_char_p
    # N, n, m -> floats of K7's workspace (csrc/ilqr_backward_wide.cu)
    lib.npt_ilqr_backward_workspace.argtypes = (_I, _I, _I)
    lib.npt_ilqr_backward_workspace.restype = ctypes.c_longlong
    # n, m -> the wide K7's form: 2 or 1 stage buffers in shared memory, 0 a workspace
    lib.npt_ilqr_backward_wide_depth.argtypes = (_I, _I)
    lib.npt_ilqr_backward_wide_depth.restype = ctypes.c_int
    # N, n, p, has_u (N, n) -> floats of the wide K9's (K10's) workspace
    # (csrc/kalman_wide.cu); n, p, has_u (n) -> its plan, 100 form + tile
    lib.npt_kalman_mean_wide_workspace.argtypes = (_I, _I, _I, _I)
    lib.npt_kalman_mean_wide_workspace.restype = ctypes.c_longlong
    lib.npt_rts_mean_wide_workspace.argtypes = (_I, _I)
    lib.npt_rts_mean_wide_workspace.restype = ctypes.c_longlong
    lib.npt_kalman_mean_wide_plan.argtypes = (_I, _I, _I)
    lib.npt_kalman_mean_wide_plan.restype = ctypes.c_int
    lib.npt_rts_mean_wide_plan.argtypes = (_I,)
    lib.npt_rts_mean_wide_plan.restype = ctypes.c_int
    return lib


@functools.cache
def _function(name: str):
    return getattr(library(), name)


def launch(name: str, device: torch.device, *args) -> int:
    """Call the library's launch function `name` with `args` and the current
    stream of `device` (a CUDA device), from that device's context; returns
    the function's CUDA error code. The function is looked up once, the
    device context is entered only when `device` is not the current one, and
    the stream's handle is read as the integer that
    ``torch.cuda.current_stream(device).cuda_stream`` holds, without building
    the Stream object (~6 us of host time a call on the H100's host)."""
    fn = _function(name)
    if device.index == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    with torch.cuda.device(device):
        return fn(*args, torch._C._cuda_getCurrentRawStream(device.index))


def check(code: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if code != 0:
        text = library().npt_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({text})")
