#!/usr/bin/env python3
"""The narrow K13's bits before and after a change, and the wide K13's
phase of chip_smoke.py (phase 32) on its own.

    python probes/mppi_wide.py digests ROOT OUT.json
    python probes/mppi_wide.py phase PARENT.json

(from the repository root, on the GPU machine). ``digests`` imports the
package of the checkout at ROOT (this repository's, or an unpacked parent
commit's, whose kernels it builds into ROOT/build/) and writes the SHA-256
prefixes of the narrow K13's us and ess (chip_smoke.k13_checksums: the MPPI
bench's shape and the envelope K = 1024, T*m = 1024, operands from numpy's
generator) to OUT.json. ``phase`` runs chip_smoke.wide_mppi_family with the
digests of PARENT.json as the narrow kernel's expected bits and prints the
kernel's entry of the JSON line. The card's name and power limit go beside
the results.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]


def smoke_module():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main() -> int:
    if not torch.cuda.is_available():
        print("mppi_wide: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    mode = sys.argv[1]
    if mode == "digests":
        root, out = Path(sys.argv[2]).resolve(), Path(sys.argv[3])
        sys.path.insert(0, str(root))  # the checkout's package, before this one's
        smoke = smoke_module()
        import numpower_tpu_torch

        got = {case: d for case, (d, _) in smoke.k13_checksums(dev).items()}
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(got, indent=1))
        print(f"[mppi_wide] narrow K13 digests of {numpower_tpu_torch.__file__}: {got} [{smi}]")
        return 0
    sys.path.insert(0, str(HERE))
    smoke = smoke_module()
    from numpower_tpu_torch.kernels import _build

    _build.library()
    for entry, line in smoke.ptxas_lines(_build.library_path().with_suffix(".so.log").read_text()):
        if "mppi" in entry:
            print(f"[mppi_wide] ptxas {entry}: {line}")
    smoke.K13_NARROW_DIGESTS = json.loads(Path(sys.argv[2]).read_text())
    print(json.dumps(smoke.wide_mppi_family(dev, smi)))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
