#!/usr/bin/env python3
"""The chain floor of a kernel's step loop, read from its SASS.

    python probes/chain_floor.py KERNEL_SUBSTRING [...]   (PYTHONPATH = the repository root)

For each kernel of the package's library (numpower_tpu_torch.kernels._build)
whose demangled name holds one of the substrings, finds its step loop: of the
ranges that end in a branch back to their start, the one with the most FFMA
(the shortest of those that tie, so not a loop around it). It follows one
pass of the loop along its likely path (conditional branches not taken, so
the slow paths of sinf and of an IEEE division stay out), and runs that
path 24 times over with each register's ready time carried from one pass to
the next: an instruction starts when its source registers are ready and its
destination is ready LATENCY cycles later. The growth of the latest
ready time per pass, once steady, is the longest dependent path through one
pass of the loop: the least time a pass can take whatever the issue rate.
Prints it beside the pass's instruction count (the least time at one
instruction a cycle) and its opcode histogram, so a pass that the compiler
unrolled over several steps can be told apart (count a marker opcode).

Latencies (cycles, Hopper, from published microbenchmarks, rounded): the
fp32 and integer ALU ops 4, MUFU 16, conversions 13, shared-memory loads 29,
anything else that writes a register 4.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from numpower_tpu_torch.kernels import _build  # noqa: E402

LATENCY = {"MUFU": 16, "F2I": 13, "I2F": 13, "F2F": 13, "LDS": 29, "LDSM": 29}
NO_DEST = ("ST", "STS", "STG", "STL", "RED", "BRA", "BAR", "EXIT", "CALL", "RET", "BSSY",
           "BSYNC", "WARPSYNC", "NOP", "SYNCS", "UBLKCP", "FENCE", "MEMBAR", "DEPBAR", "YIELD",
           "CCTL", "ERRBAR", "BPT", "NANOSLEEP", "ARRIVES", "LDGSTS", "UTMALDG")
PASSES = 24

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?);")
_REG = re.compile(r"\b(U?R\d+|U?P\d+)\b")


def sass_functions(library: Path) -> dict:
    """{demangled kernel: [(address, text)]} from cuobjdump -sass."""
    cuobjdump = str(Path(_build._nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([cuobjdump, "-sass", str(library)], capture_output=True, text=True,
                          check=True).stdout
    funcs, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            funcs[name] = []
        elif name is not None:
            m = _INSN.search(line)
            if m:
                funcs[name].append((int(m.group(1), 16), m.group(2).strip()))
    names = subprocess.run(["c++filt"], input="\n".join(funcs), capture_output=True, text=True,
                           check=True).stdout.splitlines()
    return {d.split("(")[0]: body for d, body in zip(names, funcs.values())}


def branch_target(text: str):
    m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", text)
    return int(m.group(1), 16) if m else None


def opcode(text: str) -> str:
    t = re.sub(r"^@!?U?P[T\d]+\s+", "", text)
    return t.split()[0] if t.split() else ""


def loops(body):
    """(start, end) index ranges of the backward branches."""
    index = {addr: i for i, (addr, _) in enumerate(body)}
    out = []
    for i, (addr, text) in enumerate(body):
        tgt = branch_target(text)
        if tgt is not None and tgt <= addr and tgt in index:
            out.append((index[tgt], i))
    return out


def dests_and_sources(text: str):
    op = opcode(text)
    base = op.split(".")[0]
    t = re.sub(r"^@!?(U?P[T\d]+)\s+", "", text)
    guard = re.match(r"^@!?(U?P\d+)\s+", text)
    operands = t[len(op):].strip()
    regs = _REG.findall(operands)
    srcs = [guard.group(1)] if guard else []
    if base in NO_DEST or not regs:
        return [], srcs + regs
    dest, rest = regs[0], regs[1:]
    if base in ("ISETP", "FSETP", "DSETP", "PSETP", "HSETP2") and len(rest) >= 1 \
            and rest[0].lstrip("U").startswith("P"):
        rest = rest[1:]  # the second predicate destination
    width = 4 if ".128" in op else 2 if (".64" in op or ".WIDE" in op) else 1
    dests = [dest]
    if dest.lstrip("U").startswith("R") and dest not in ("RZ", "URZ"):
        num = int(dest.lstrip("U")[1:])
        prefix = "UR" if dest.startswith("U") else "R"
        dests = [f"{prefix}{num + k}" for k in range(width)]
    return dests, srcs + rest


def latency(text: str) -> int:
    base = opcode(text).split(".")[0]
    return LATENCY.get(base, 4)


def fast_path(body, start: int, end: int) -> list:
    """The instructions of one pass of the loop body[start..end] along its
    likely path: a conditional branch is not taken (the slow paths of sinf
    and of an IEEE division are the targets of theirs), an unconditional one
    is followed, and the pass ends at the branch back to the loop's start."""
    index = {addr: i for i, (addr, _) in enumerate(body)}
    path, i = [], start
    while start <= i < len(body) and len(path) < 20000:
        text = body[i][1]
        base = opcode(text).split(".")[0]
        if base == "EXIT" or i == end:
            break
        if base == "BRA" and not text.startswith("@"):
            tgt = branch_target(text)
            if tgt is None or tgt == body[start][0] or tgt not in index:
                break
            i = index[tgt]
            continue
        if base != "BRA":
            path.append(text)
        i += 1
    return path


def chain_floor(body) -> dict:
    ranges = loops(body)
    if not ranges:
        return {"error": "no loop"}
    ffma = lambda r: sum(opcode(body[i][1]).startswith("FFMA") for i in range(r[0], r[1] + 1))  # noqa: E731
    # the most FFMA; of loops that hold as many (an outer loop around the
    # step loop), the shortest
    start, end = max(ranges, key=lambda r: (ffma(r), r[0] - r[1]))
    insns = fast_path(body, start, end)
    ready, peaks = {}, []
    for _ in range(PASSES):
        for text in insns:
            dests, srcs = dests_and_sources(text)
            t0 = max((ready.get(r, 0) for r in srcs if r not in ("RZ", "URZ", "PT", "UPT")),
                     default=0)
            for d in dests:
                ready[d] = t0 + latency(text)
        peaks.append(max(ready.values(), default=0))
    steady = (peaks[-1] - peaks[PASSES // 2]) / (PASSES - 1 - PASSES // 2)
    hist = Counter(opcode(t).split(".")[0] for t in insns)
    return {"range": [hex(body[start][0]), hex(body[end][0])], "instructions": len(insns),
            "chain_cycles_per_pass": steady, "opcodes": dict(hist.most_common())}


def main() -> int:
    wanted = sys.argv[1:]
    funcs = sass_functions(_build.build())
    out = {}
    for name, body in funcs.items():
        if any(w in name for w in wanted):
            out[name] = chain_floor(body)
            print(f"[chain_floor] {name}: {json.dumps(out[name])}", flush=True)
    return 0 if out else 1


if __name__ == "__main__":
    sys.exit(main())
