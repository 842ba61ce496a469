#!/usr/bin/env python3
"""Wall time of each kernel source's nvcc on the card's machine, compiled
side by side as numpower_tpu_torch.kernels._build compiles them (one nvcc a
source, all started together, the package's flags), longest first, then
the package's own build of the library (no time at all when the library
of these sources is already built: it is only loaded).

    python probes/compile_times.py     (from the repository root)

The objects go to build/probes/objects/; the library to the package's
build directory. A source's time here is what it adds to the build when it
is the last to finish (chip_smoke.py logs the build's wall time).
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from numpower_tpu_torch.kernels import _build  # noqa: E402


def main() -> int:
    out = Path(__file__).resolve().parents[1] / "build" / "probes" / "objects"
    out.mkdir(parents=True, exist_ok=True)
    nvcc, started = _build._nvcc(), {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        cmd = [nvcc, *_build.NVCC_FLAGS, "-c", "-o", str(out / f"{src.stem}.o"), str(src)]
        started[src.name] = (time.perf_counter(),
                             subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                              stderr=subprocess.DEVNULL))
    done = {}
    while len(done) < len(started):
        for name, (t0, proc) in started.items():
            if name not in done and proc.poll() is not None:
                done[name] = (time.perf_counter() - t0, proc.returncode)
        time.sleep(0.1)
    for name, (seconds, rc) in sorted(done.items(), key=lambda kv: -kv[1][0]):
        print(f"compile {name}: {seconds:.1f} s (exit {rc})")
    t0 = time.perf_counter()
    _build.library()
    print(f"the package's build: {time.perf_counter() - t0:.1f} s -> {_build.library_path().name}")
    return 0 if all(rc == 0 for _, rc in done.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
