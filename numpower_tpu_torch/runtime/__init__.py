"""The port's native runtime (ctypes over its own libndruntime.so), the
counterpart of numpower_tpu/runtime/__init__.py's registry and .npy paths.

NumPower tracks every NDArray in a C registry with allocation counters
(buffer.c) and exposes leak checks; ``register``/``unregister``/``stats``/
``leak_check`` bind the same registry from ``runtime/src/ndruntime.cpp``, a
copy of the JAX package's source. ``npy_save_fast`` and ``npy_read_fast`` are
its writev writer and mmap reader of .npy files. The same library holds the
scenario stream's ring-buffer generator (``runtime/src/scenario_stream.cpp``,
also a copy), which ``runtime/stream.py`` drives. This is host bookkeeping:
nothing here touches a device.

The library is built from both sources with ``g++`` at first use into
``build/numpower_tpu_torch/`` at the repository root (the name carries a hash
of the sources, and a build
lands under a temporary name before it is renamed into place, so concurrent
processes never load a half-written file); it never writes into the JAX
package's directory. Where no library can be built or loaded, the registry
is the pure-Python one below and the .npy paths report themselves
unavailable (False / None), so the caller takes numpy's.
"""

from __future__ import annotations

import ctypes
import hashlib
import io
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_SRCS = tuple(Path(__file__).resolve().parent / "src" / name
              for name in ("ndruntime.cpp", "scenario_stream.cpp"))
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "numpower_tpu_torch"
_GXX = ("g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lib = None
_tried = False
_lock = threading.Lock()


def library_path() -> Path:
    """Where the library of these sources lives (its name holds the sources'
    hash)."""
    digest = hashlib.sha256(b"".join(src.read_bytes() for src in _SRCS)
                            + " ".join(_GXX).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libndruntime-{digest}.so"


def _build(path: Path) -> bool:
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
    os.close(fd)
    try:
        subprocess.run([*_GXX, "-o", tmp, *map(str, _SRCS)], check=True, capture_output=True,
                       timeout=180)
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    """The loaded library, building it the first time; None where it cannot
    be built or loaded (then the Python registry serves)."""
    global _lib, _tried
    if _tried:
        return _lib
    with _lock:
        if _tried:
            return _lib
        path = library_path()
        try:
            if path.is_file() or _build(path):
                lib = ctypes.CDLL(str(path))
                lib.nptpu_register.argtypes = [ctypes.c_uint64]
                lib.nptpu_register.restype = ctypes.c_uint64
                lib.nptpu_unregister.argtypes = [ctypes.c_uint64, ctypes.c_uint64]
                lib.nptpu_unregister.restype = ctypes.c_int
                lib.nptpu_stats.argtypes = [ctypes.POINTER(ctypes.c_uint64)]
                lib.nptpu_leak_check.restype = ctypes.c_uint64
                lib.nptpu_npy_save.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64,
                                               ctypes.c_void_p, ctypes.c_uint64]
                lib.nptpu_npy_save.restype = ctypes.c_int
                lib.nptpu_npy_read.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                               ctypes.c_void_p, ctypes.c_uint64]
                lib.nptpu_npy_read.restype = ctypes.c_int
                _bind_stream(lib)
                _lib = lib
        except OSError:
            _lib = None
        _tried = True
        return _lib


def _bind_stream(lib) -> None:
    """Declare the five nptpu_stream_* functions (scenario_stream.cpp)."""
    lib.nptpu_stream_create.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64,
                                        ctypes.c_int32, ctypes.c_float, ctypes.c_int32,
                                        ctypes.c_int32]
    lib.nptpu_stream_create.restype = ctypes.c_void_p
    lib.nptpu_stream_acquire.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
    lib.nptpu_stream_acquire.restype = ctypes.c_int32
    lib.nptpu_stream_data.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.nptpu_stream_data.restype = ctypes.POINTER(ctypes.c_float)
    lib.nptpu_stream_release.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.nptpu_stream_release.restype = None
    lib.nptpu_stream_destroy.argtypes = [ctypes.c_void_p]
    lib.nptpu_stream_destroy.restype = None


class _PyRegistry:
    """The registry where the library is unavailable: the same counters."""

    def __init__(self):
        self._lock = threading.Lock()
        self._next = 1
        self._live = {}
        self.total_registered = 0
        self.total_freed = 0
        self.live_bytes = 0
        self.peak_bytes = 0

    def register(self, nbytes: int) -> int:
        with self._lock:
            uid = self._next
            self._next += 1
            self._live[uid] = nbytes
            self.total_registered += 1
            self.live_bytes += nbytes
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            return uid

    def unregister(self, uid: int, nbytes: int) -> None:
        with self._lock:
            if uid in self._live:
                del self._live[uid]
                self.total_freed += 1
                self.live_bytes -= nbytes

    def stats(self) -> dict:
        with self._lock:
            return {"total_registered": self.total_registered, "total_freed": self.total_freed,
                    "live_count": len(self._live), "live_bytes": self.live_bytes,
                    "peak_bytes": self.peak_bytes}


_py_registry = _PyRegistry()


def native_available() -> bool:
    return _load() is not None


def register(nbytes: int) -> int:
    """NumPower's add_to_buffer: a new uuid for a wrapper of nbytes."""
    lib = _load()
    if lib is not None:
        return int(lib.nptpu_register(int(nbytes)))
    return _py_registry.register(int(nbytes))


def unregister(uuid: int, nbytes: int) -> None:
    """NumPower's buffer_ndarray_free."""
    lib = _load()
    if lib is not None:
        lib.nptpu_unregister(int(uuid), int(nbytes))
    else:
        _py_registry.unregister(uuid, int(nbytes))


def stats() -> dict:
    """NumPower's buffer_dump counters: total_registered, total_freed,
    live_count, live_bytes, peak_bytes."""
    lib = _load()
    if lib is None:
        return _py_registry.stats()
    buf = (ctypes.c_uint64 * 5)()
    lib.nptpu_stats(buf)
    keys = ("total_registered", "total_freed", "live_count", "live_bytes", "peak_bytes")
    return {k: int(v) for k, v in zip(keys, buf)}


def leak_check() -> int:
    """NumPower's vmemcheck: the live wrapper count."""
    return stats()["live_count"]


def npy_save_fast(path: str, arr: np.ndarray) -> bool:
    """Write `arr` as a .npy file at `path` (exactly that path) in one writev;
    False where the library is unavailable or `arr` is not C-contiguous (the
    caller then takes np.save)."""
    lib = _load()
    if lib is None or not arr.flags["C_CONTIGUOUS"]:
        return False
    hdr = io.BytesIO()
    np.lib.format.write_array_header_1_0(hdr, np.lib.format.header_data_from_array_1_0(arr))
    header = hdr.getvalue()
    rc = lib.nptpu_npy_save(str(path).encode(), header, len(header),
                            arr.ctypes.data_as(ctypes.c_void_p), arr.nbytes)
    return rc == 0


def npy_read_fast(path: str):
    """Read a .npy file: the header parsed in Python, the data copied out of
    a read-only mapping in one memcpy. None where the library is unavailable
    or the file needs np.load's other paths (Fortran order, object dtype, an
    unknown version); the caller then takes np.load."""
    lib = _load()
    if lib is None:
        return None
    try:
        with open(path, "rb") as f:
            version = np.lib.format.read_magic(f)
            if version == (1, 0):
                shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
            elif version == (2, 0):
                shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
            else:
                return None
            offset = f.tell()
    except (OSError, ValueError):
        return None
    if fortran or dtype.hasobject:
        return None
    arr = np.empty(shape, dtype)
    if arr.nbytes == 0:
        return arr
    rc = lib.nptpu_npy_read(str(path).encode(), offset, arr.ctypes.data_as(ctypes.c_void_p),
                            arr.nbytes)
    return arr if rc == 0 else None
