#!/usr/bin/env python3
"""chip_smoke.py with phase 29 run right after phase 28 instead of just
before phase 23: what that order does to phase 8's torch.profiler count of
its 19 replayed ticks.

    python probes/phase29_order.py        (from the repository root)

chip_smoke.main is run as it is, with two of its functions replaced in the
module: wide_riccati_family (phase 28) runs phase 29 (wide_ilqr_family)
after itself and keeps its result, and the later call of wide_ilqr_family
returns that result. Phase 8 counts its replayed ticks in the second of
two calls in one trace (chip_smoke.kernel_runs, warm), and logs how many
records of its kernel the warm call kept: in this order the warm call
loses one, the first graph launch of the trace. Where a count comes up
short, kernel_runs logs the trace's GPU records by name and the graph
launches with no record of the kernel, and the run stops at phase 8's
check (exit 1). Output as chip_smoke.py's; the card's name and power limit
in its lines.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    riccati, ilqr, kept = cs.wide_riccati_family, cs.wide_ilqr_family, []

    def riccati_then_ilqr(dev, smi):
        out = riccati(dev, smi)
        cs.log("phase 29 right after phase 28 (probes/phase29_order.py)")
        kept.append(ilqr(dev, smi))
        return out

    cs.wide_riccati_family = riccati_then_ilqr
    cs.wide_ilqr_family = lambda dev, smi: kept.pop()
    return cs.main()


if __name__ == "__main__":
    sys.exit(main())
