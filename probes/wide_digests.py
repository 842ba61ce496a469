#!/usr/bin/env python3
"""The digests that the wide K6b, the wide K9's forms 1 and 2 and the wide K10
must keep across a redesign, printed for one checkout's kernels.

    python probes/wide_digests.py [ROOT]   (from the repository root; one card)

Imports chip_smoke from this repository and numpower_tpu_torch from ROOT
(default: this repository), builds ROOT's kernels there, and prints
chip_smoke.k6b_wide_checksums and chip_smoke.kalman_wide_checksums as one
JSON object, with the card's name and power limit. Run on an unpacked
parent (git archive into a directory .gitignore lists) and on this
checkout in one call: equal digests are equal bits.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def main() -> int:
    root = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else HERE
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("wide_digests: needs a CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import numpower_tpu_torch

    assert Path(numpower_tpu_torch.__file__).resolve().is_relative_to(root)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    out = {"root": str(root), "card": smi}
    for name, fn in (("K6B_WIDE_DIGESTS", cs.k6b_wide_checksums),
                     ("K9_WIDE_DIGESTS", cs.kalman_wide_checksums)):
        out[name] = {case: d for case, (d, _) in fn(dev).items()}
    print(json.dumps(out, indent=1), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
