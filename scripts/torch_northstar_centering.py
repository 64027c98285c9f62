#!/usr/bin/env python3
"""The centering of a large raw Gram, float32 as the JAX package forms it
against the port's `centering_terms`, at the JAX bench's `northstar` cell.

Usage, from the root of a checkout, on a machine with one CUDA card:

    python3 scripts/torch_northstar_centering.py [--n 50000] [--p 500000] [--shards 8]

It makes the cell's shards as `chip_smoke.py` phase 15 (c) does (int8
dosages, (p/shards, n) SNP-major, seeded on the card) and accumulates them
into 4096-wide int32 trapezoid pieces (`ops/pieces.py`), timing each
shard's products (`torch._int_mm`) and K1 on the first shard
(`gram_tri_snp_major`). Then it centers the pieces two ways:

1. as the JAX package does (genomicbreedingmodels_tpu/ops/pieces.py:131-167):
   float32 row sums, rm and gm in float32, P - (rm_i + rm_j - gm);
2. as the port does (`center_scale_pieces`: float64 row sums, the
   correction applied as a_i, b_j, c_i, ops/grm.py:centering_terms);

and for each prints 1ᵀK1/n (0 in exact arithmetic: the ones vector is the
centered Gram's null direction) beside λ = 1e-3·mean(diag K), and the CG
of `cg_solve_pieces` step by step (pAp and the residual's squared norm) on
a seeded y. With the float32 form a negative 1ᵀK1/n below -λ makes K + λI
indefinite, and CG diverges. It imports neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def center_f32(pieces, bounds):
    """The JAX package's center_scale_pieces on raw int32 pieces, in float32."""
    import torch

    n = pieces[0].shape[0]
    out = []
    for (lo, hi), P in zip(bounds, pieces):
        P = P.to(torch.float32) / 4.0
        P[: hi - lo] = torch.tril(P[: hi - lo])
        out.append(P)
    rs, cs, dg = (torch.zeros(n, device=pieces[0].device) for _ in range(3))
    for (lo, hi), P in zip(bounds, out):
        rs[lo:] += P.sum(dim=1)
        cs[lo:hi] += P.sum(dim=0)
        dg[lo:hi] = P[: hi - lo].diagonal()
    rm = (rs + cs - dg) / n
    gm = rm.mean()
    for (lo, hi), P in zip(bounds, out):
        P -= rm[lo:, None] + rm[None, lo:hi] - gm
        P[: hi - lo] = torch.tril(P[: hi - lo])
    return out


def report(label, pieces, bounds, y, iters=30):
    """1ᵀK1/n, λ and the CG trace of `cg_solve_pieces`'s iteration."""
    import torch

    n = y.shape[0]
    dg = torch.cat([P[: hi - lo].diagonal() for (lo, hi), P in zip(bounds, pieces)])
    lam = 1e-3 * dg.sum() / n

    def mv(v):
        out = lam * v - dg * v
        for (lo, hi), P in zip(bounds, pieces):
            out[lo:] += P @ v[lo:hi]
            out[lo:hi] += P.T @ v[lo:]
        return out

    one = torch.ones(n, device=y.device)
    k1 = float(one @ (mv(one) - lam * one)) / n
    yc = y - y.mean()
    x, r, pv = torch.zeros_like(yc), yc.clone(), yc.clone()
    rs = r @ r
    trace = []
    for _ in range(iters):
        Ap = mv(pv)
        pap = pv @ Ap
        alpha = rs / pap.clamp_min(1e-30)
        x, r = x + alpha * pv, r - alpha * Ap
        rs_new = r @ r
        pv = r + (rs_new / rs.clamp_min(1e-30)) * pv
        rs = rs_new
        trace.append((float(pap), float(rs)))
    print(f"{label}: 1ᵀK1/n = {k1:.6g}, λ = {float(lam):.6g}; final ‖r‖ = {trace[-1][1] ** 0.5:.3g}")
    print("  CG (pAp, ‖r‖²) by iteration: " + "; ".join(
        f"{i}: {a:.3g}, {b:.3g}" for i, (a, b) in enumerate(trace)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_northstar_centering: needs one CUDA card", file=sys.stderr)
        return 1
    from genomicbreedingmodels_tpu_torch.ops import pieces as pc
    from genomicbreedingmodels_tpu_torch.ops.grm import gram_tri_snp_major

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--p", type=int, default=500_000)
    ap.add_argument("--shards", type=int, default=8)
    a = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    n, cols = a.n, a.p // a.shards

    def shard(k):  # chip_smoke.py phase 15 (c)'s shards
        gen.manual_seed(15 * 1000 + k)
        return torch.randint(0, 3, (cols, n), dtype=torch.int8, device=dev, generator=gen)

    gen.manual_seed(15)
    y = torch.randn(n, device=dev, generator=gen)
    bounds = pc.make_bounds(n, 4096)
    pieces = pc.zero_pieces(n, bounds, device=dev)
    ms = []
    for k in range(a.shards):
        F = shard(k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pc.accumulate_dosage_shard(pieces, F, bounds=bounds)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if k == 0:
            gram_tri_snp_major(F, 2, device=dev)  # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gram_tri_snp_major(F, 2, device=dev)
            torch.cuda.synchronize()
            k1_ms = (time.perf_counter() - t0) * 1e3
        del F
    print(f"{n}x{a.p} in {a.shards} shards of {cols}: pieces products (transposing copy + "
          f"torch._int_mm) per shard {', '.join(f'{t:.1f}' for t in ms)} ms; K1 with its "
          f"transposing copy on shard 0 {k1_ms:.1f} ms [{card}]")
    report("float32 centering (the JAX package's)", center_f32(pieces, bounds), bounds, y)
    report("the port's centering_terms", pc.center_scale_pieces(pieces, 4.0, bounds=bounds), bounds, y)
    return 0


if __name__ == "__main__":
    sys.exit(main())
