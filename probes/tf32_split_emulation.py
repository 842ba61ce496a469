#!/usr/bin/env python3
"""The wide K5's arithmetic emulated on the host, to choose its 3xTF32 form
before a card run: the recursion of csrc/riccati_wide.cu (Y = P [A | B],
the blocks of [A | B]'Y, S inverted by Gauss-Jordan in fp32, K = S^{-1}
B'PA, P' = Q + A'PA - (B'PA)'K's upper triangle mirrored) with each product
as mma.sync m16n8k8 TF32 passes would compute it, against the plain version
in fp32 and float64 with phase 28's bounds.

    python probes/tf32_split_emulation.py [N] [rz|rn]   (from the repository root; CPU)

The model of a pass: TF32 operands (a float's top 19 bits: truncation where
the kernel hands mma.sync raw fp32 words), each product exact, the eight
products of a k-step and the accumulator summed and rounded toward zero
("rz", the tensor cores' sum is not round-to-nearest) or to nearest ("rn")
in fp32. Forms (FORMS): "truncated" (hi truncated, hi*hi summed in the
accumulator over the k loop: tf32_mma.cuh's default, the wide K7's);
"truncated on A - I" (the same with [A - I | B] staged and the identity's
terms P and PA added in fp32); "rounded, one accumulator" (hi rounded to the
nearest); "rounded" (hi rounded, each k-step's hi*hi from a fresh
accumulator added in fp32: tf32_mma.cuh's kRound, the wide K5's). Plants
(chip_smoke phase 28): the four-quadrotor formation (n = 48, m = 16, T = 30)
on its first N scenarios (default 64), and with A far from the identity
(chip_smoke.formation_far: -As, As O). Prints, per plant and form, max |d|
of Ks and P0 from the plain fp32 version, the scaled distance from it
(at most 1 where rtol 1e-3 / atol 1e-4 on Ks and 1e-3 on P0 hold) and the
scaled distance from float64 beside the plain version's own. ~1-2 minutes
on a few cores at N = 64.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from numpower_tpu_torch.kernels import riccati  # noqa: E402

F32, F64 = torch.float32, torch.float64
ACC = "rz"
# name: (hi rounded, hi*hi a fresh accumulator each k-step, [A - I | B] staged)
FORMS = {"truncated": (False, False, False), "truncated on A - I": (False, False, True),
         "rounded, one accumulator": (True, False, False), "rounded": (True, True, False)}


def tf32(x: torch.Tensor, rounded: bool) -> torch.Tensor:
    """x's top 19 bits, after half of the low 13 bits' range is added where
    `rounded` (round to nearest, ties away from zero)."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000 if rounded else b) & -8192).view(F32)


def to_f32(x64: torch.Tensor) -> torch.Tensor:
    """float64 to fp32 as the accumulator rounds (ACC)."""
    y = x64.float()
    if ACC == "rn":
        return y
    over = y.double().abs() > x64.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def product(A: torch.Tensor, B: torch.Tensor, rounded: bool, fresh: bool) -> torch.Tensor:
    """A (N, r, k) @ B (N, k, c) in three TF32 passes (hi*lo and lo*hi into
    one accumulator, hi*hi into another, the two added in fp32)."""
    pad = (-A.shape[-1]) % 8
    A = torch.nn.functional.pad(A, (0, pad))
    B = torch.nn.functional.pad(B, (0, 0, 0, pad))
    ah, bh = tf32(A, rounded), tf32(B, rounded)
    al, bl = tf32(A - ah, False), tf32(B - bh, False)  # lo read raw: truncated
    hh = torch.zeros(A.shape[0], A.shape[1], B.shape[2], dtype=F32)
    cr = torch.zeros_like(hh)
    for kk in range(A.shape[-1] // 8):
        s = slice(8 * kk, 8 * kk + 8)

        def dot(x, y):
            return x[..., s].double() @ y[:, s, :].double()

        cr = to_f32(cr.double() + dot(al, bh))
        cr = to_f32(cr.double() + dot(ah, bl))
        if fresh:
            hh = (hh.double() + to_f32(dot(ah, bh)).double()).float()
        else:
            hh = to_f32(hh.double() + dot(ah, bh))
    return (hh.double() + cr.double()).float()


def gauss_jordan(S: torch.Tensor) -> torch.Tensor:
    """S^{-1} in fp32 as spd_inverse_sweep computes it (no pivot search)."""
    rows = S.clone()
    m = S.shape[-1]
    for k in range(m):
        d = (1.0 / rows[:, k, k].double()).float()
        f = rows[:, :, k].clone()
        pivot = rows[:, k, :].clone()
        for j in range(m):
            if j == k:
                continue
            akj = (pivot[:, j].double() * d.double()).float()
            col = (rows[:, :, j].double() - f.double() * akj[:, None].double()).float()
            col[:, k] = akj
            rows[:, :, j] = col
        col = (-f.double() * d[:, None].double()).float()
        col[:, k] = d
        rows[:, :, k] = col
    return rows


def kernel(As, Bs, Q, R, QF, T, form):
    rounded, fresh, shifted = FORMS[form]
    N, n, _ = As.shape
    Q, R, QF = (torch.as_tensor(x, dtype=F32) for x in (Q, R, QF))
    M = torch.cat([As - torch.eye(n) if shifted else As, Bs], -1)
    MA, MB = M[:, :, :n].transpose(1, 2).contiguous(), M[:, :, n:].transpose(1, 2).contiguous()
    P = QF.expand(N, n, n).clone()
    Ks = torch.empty(N, T, Bs.shape[-1], n)

    def mm(x, y):
        return product(x, y, rounded, fresh)

    for t in range(T):
        Y = mm(P, M)
        if shifted:
            Y[:, :, :n] += P
        YA, YB = Y[:, :, :n].contiguous(), Y[:, :, n:].contiguous()
        S = mm(MB, YB) + R
        G = mm(MB, YA)
        APA = (mm(MA, YA) + YA if shifted else mm(MA, YA)) + Q
        K = mm(gauss_jordan(S), G)
        Pn = APA - mm(G.transpose(1, 2).contiguous(), K)
        P = torch.triu(Pn) + torch.triu(Pn, 1).transpose(1, 2)
        Ks[:, T - 1 - t] = K
    return Ks, P


def scaled(Ks, P0, Ks_ref, P0_ref) -> float:
    return max(cs.scaled_err(Ks, Ks_ref, 1e-3, 1e-4), cs.scaled_err(P0, P0_ref, 1e-3, 1e-3))


def main() -> int:
    global ACC
    N = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    ACC = sys.argv[2] if len(sys.argv) > 2 else "rz"
    torch.set_num_threads(min(8, torch.get_num_threads()))
    plants = {"formation": cs.formation(cs.N_FORMATION, N)}
    plants.update({f"A {k}": cs.formation_far(k, cs.N_FORMATION, N) for k in cs.FAR_FROM_I})
    for what, (As, B, Q, R, QF) in plants.items():
        As = torch.as_tensor(As)
        Bs = torch.as_tensor(B).expand(N, *B.shape).contiguous()
        Ks_p, P0_p = riccati.riccati_batched_reference(As, Bs, Q, R, QF, cs.T)
        Ks_64, P0_64 = riccati.riccati_batched_reference(As.double(), Bs.double(), Q, R, QF, cs.T)
        e_p = scaled(Ks_p, P0_p, Ks_64, P0_64)
        print(f"{what} (N = {N}, T = {cs.T}, sums {ACC}): |P0| {P0_64.abs().max():.3e}; the "
              f"plain fp32 version from float64, scaled {e_p:.3f}", flush=True)
        for form in FORMS:
            Ks, P0 = kernel(As, Bs, Q, R, QF, cs.T, form)
            e_k, e_v = scaled(Ks, P0, Ks_64, P0_64), scaled(Ks, P0, Ks_p, P0_p)
            held = e_v <= 1.0 and e_k <= max(1.0, 4 * e_p)
            print(f"  {form:26s} max|dKs| {cs.max_err(Ks, Ks_p):.2e} max|dP0| "
                  f"{cs.max_err(P0, P0_p):.2e} from plain, scaled {e_v:.3f}; from float64 "
                  f"{e_k:.3f}: {'held' if held else 'NOT HELD'}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
