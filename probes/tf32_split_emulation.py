#!/usr/bin/env python3
"""The wide K5's and the wide K9's arithmetic emulated on the host, to
choose their 3xTF32 form before a card run, each product as mma.sync
m16n8k8 TF32 passes would compute it, against the plain version in fp32 and
float64:
  - K5 (csrc/riccati_wide.cu), with phase 28's bounds: Y = P [A | B], the
    blocks of [A | B]'Y, S inverted by Gauss-Jordan in fp32, K = S^{-1}
    B'PA, P' = Q + A'PA - (B'PA)'K's upper triangle mirrored;
  - K9 (csrc/kalman_wide.cu's form 0), with phase 30's bounds (means atol
    2e-5, ll rtol 2e-4 / atol 2e-3, or four times the plain fp32 version's
    own distance from float64): x_p = x A' + u_t, v = y_t - x_p C',
    x = x_p + v W_t, alpha = v invL_t', ll -= 0.5 |alpha|^2 + cst_t, the
    three dependent products in that order ("split": x_p C' over two halves
    of its k-steps, v = (y_t - the first) - the second, a form tried and not
    kept: slower on the card), on the four-quadrotor formation
    (chip_smoke.quad_estimation: n = 48, p = 24) and on a random stable
    (130, 67) system (chip_smoke.random_estimation), each with inputs, on
    N trajectories of T_K9 = 50 steps.

    python probes/tf32_split_emulation.py [N] [rz|rn] [k5|k9]   (from the repository root; CPU)

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
scaled distance from float64 beside the plain version's own; for K9 the
scaled distances of the means and of ll. ~1-2 minutes on a few cores at
N = 64 for K5, about as long for K9.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from numpower_tpu_torch.kernels import kalman_mean, riccati  # noqa: E402

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


T_K9 = 50
K9_FORMS = ("truncated", "rounded", "rounded, split")


def k9_kernel(A, C, Ws, invLs, logdets, x0s, ys_t, us_t, form):
    """csrc/kalman_wide.cu's form 0 emulated: each product in the 3xTF32
    form `form` (", split": x_p C' over two halves of its k-steps), the sums
    around them in fp32."""
    split = form.endswith(", split")
    rounded, fresh, _ = FORMS[form.removesuffix(", split")]
    n = A.shape[0]
    cut = 8 * ((-(-n // 8) + 1) // 2)  # the first half's k-steps, of 8

    def mm(x, M):  # x (N, k) @ M (k, c)
        return product(x[None], M[None].contiguous(), rounded, fresh)[0]

    cst = kalman_mean._step_constants(logdets, ys_t.shape[-1])
    x, ll = x0s, torch.zeros(x0s.shape[0])
    xs_f, xs_p = [], []
    for t in range(ys_t.shape[0]):
        x_p = mm(x, A.T)
        if us_t is not None:
            x_p = x_p + us_t[t]
        if split and cut < n:
            v = (ys_t[t] - mm(x_p[:, :cut], C.T[:cut])) - mm(x_p[:, cut:], C.T[cut:])
        else:
            v = ys_t[t] - mm(x_p, C.T)
        x = x_p + mm(v, Ws[t])
        alpha = mm(v, invLs[t].T)
        ll = ll - 0.5 * (alpha * alpha).sum(1) - cst[t]
        xs_f.append(x)
        xs_p.append(x_p)
    return torch.stack(xs_f), torch.stack(xs_p), ll


def k9_main(N: int) -> None:
    q = {k: torch.as_tensor(v) for k, v in cs.quad_estimation(cs.N_FORMATION, N, T_K9).items()}
    systems = {"formation": q,
               "random (130, 67)": cs.random_estimation(130, 67, N, T_K9, seed=197, dev="cpu")}
    for what, d in systems.items():
        ops = cs.kalman_mean_operands(d["A"], d["C"], d["Q"], d["R"], d["P0"], d["x0s"],
                                      d["yss"], d["B"], d["uss"])
        plain = kalman_mean.kalman_mean_pass_reference(*ops)
        f64 = kalman_mean.kalman_mean_pass_reference(*(x.double() for x in ops))
        e_px = max(cs.scaled_err(plain[k], f64[k], 0.0, 2e-5) for k in range(2))
        e_pl = cs.scaled_err(plain[2], f64[2], 2e-4, 2e-3)
        n, p = ops[0].shape[0], ops[1].shape[0]
        print(f"K9 {what} (n = {n}, p = {p}, N = {N}, T = {T_K9}, with inputs, sums {ACC}): "
              f"the plain fp32 version from float64, scaled means {e_px:.3f}, ll {e_pl:.3f}",
              flush=True)
        for form in K9_FORMS:
            got = k9_kernel(*ops, form)
            held = True
            parts = []
            for k, (rtol, atol, e_p) in enumerate(((0.0, 2e-5, e_px), (0.0, 2e-5, e_px),
                                                    (2e-4, 2e-3, e_pl))):
                ok, e_kp, e_k, _ = cs.held_against(got[k], plain[k], f64[k], rtol, atol)
                held = held and ok
                parts.append(f"{('x_f', 'x_p', 'll')[k]} {cs.max_err(got[k], plain[k]):.2e} "
                             f"(scaled {e_kp:.3f} / {e_k:.3f})")
            print(f"  {form:10s} max|d| from plain (scaled from plain / float64): "
                  f"{'; '.join(parts)}: {'held' if held else 'NOT HELD'}", flush=True)


def main() -> int:
    global ACC
    N = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    ACC = sys.argv[2] if len(sys.argv) > 2 else "rz"
    which = sys.argv[3] if len(sys.argv) > 3 else "all"
    torch.set_num_threads(min(8, torch.get_num_threads()))
    if which in ("k9", "all"):
        k9_main(N)
    if which == "k9":
        return 0
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
