#!/usr/bin/env python3
"""K1 and K2 against exact references at shapes whose tiles take marker splits.

Usage, from the root of a checkout, on a CUDA card:

    python3 scripts/torch_gram_split_check.py [--shape int8:10000x102000 ...] [--repeat 2]

For each shape (dtype int8, float32 or bfloat16, then n x p) it makes a
seeded random panel (dosages in {0, 1, 2}, or uniform [0, 1)), runs the
kernel wrapper, and compares it with the plain version and, for int8, with
`torch._int_mm` (exact int32). It prints the marker splits the launch takes
(`kernels/gram_tri.py:marker_splits` with the card's cluster count), the
number of wrong elements and wrong output tiles, and, for the first wrong
tiles, the rows and columns that are wrong and whether the error equals
plus or minus one marker split's partial Gram (a split added twice or not
at all). It imports neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from genomicbreedingmodels_tpu_torch.kernels import gram_tri  # noqa: E402

DEFAULT_SHAPES = ("int8:10000x102000", "int8:9000x102000", "int8:4352x24576", "int8:3072x40960",
                  "float32:2304x32768", "bfloat16:2304x32768", "float32:2000x32768")
K2_TOL = 1e-5


def parse(spec: str):
    dt, shape = spec.split(":")
    n, p = (int(v) for v in shape.split("x"))
    return getattr(torch, dt), n, p


def splits_of(n: int, p: int, dtype: torch.dtype) -> int:
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    t = gram_tri.tiling(dtype, n, sms)
    tiles = len(gram_tri.tile_order(n, t.tile_m, t.tile_n))
    nk = -(-p * torch.empty(0, dtype=dtype).element_size() // 128)
    return gram_tri.marker_splits(tiles, sms // t.ctas, nk, t.max_splits)


def explain_tile(D, diff, i, j, tm, tn, S):
    """Rows/columns wrong in tile (i, j) and the split whose partial Gram the
    error equals (+: added twice, -: missing), if any."""
    rows = slice(i * tm, min((i + 1) * tm, D.shape[0]))
    cols = slice(j * tn, min((j + 1) * tn, D.shape[0]))
    d = diff[rows, cols]
    wrong = d != 0
    r_idx, c_idx = torch.nonzero(wrong, as_tuple=True)
    lower = torch.tril(torch.ones_like(d, dtype=torch.bool), diagonal=rows.start - cols.start)
    nk = -(-D.shape[1] // 128)
    verdict = "no single split"
    for s in range(S):
        m0, m1 = s * nk // S * 128, min((s + 1) * nk // S * 128, D.shape[1])
        part = (D[rows, m0:m1].double() @ D[cols, m0:m1].double().T) * lower  # exact: sums < 2^53
        for sign, word in ((-1, "missing"), (1, "added twice")):
            if torch.equal(d.double(), sign * part):
                verdict = f"split {s} of {S} (markers {m0}..{m1 - 1}) {word}"
    return (f"tile ({i},{j}): {int(wrong.sum())} of {int(lower.sum())} lower elements wrong, rows "
            f"{rows.start + int(r_idx.min())}..{rows.start + int(r_idx.max())}, cols "
            f"{cols.start + int(c_idx.min())}..{cols.start + int(c_idx.max())}; {verdict}")


def check(dtype, n, p, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    S = splits_of(n, p, dtype)
    label = f"{str(dtype)[6:]} {n}x{p} (marker splits {S})"
    if dtype == torch.int8:
        D = torch.randint(0, 3, (n, p), dtype=torch.int8, device="cuda", generator=gen)
        K, R = gram_tri.gram_tri_int8(D, 2), gram_tri.gram_tri_int8_plain(D, 2)
        L = torch.tril(torch._int_mm(D, D.t())) if n % 8 == 0 and p % 8 == 0 else R
        torch.cuda.synchronize()
        diff = K - L
        n_wrong = int((diff != 0).sum())
        print(f"K1 {label}: kernel==plain {torch.equal(K, R)}, kernel==_int_mm {torch.equal(K, L)}, "
              f"plain==_int_mm {torch.equal(R, L)}; {n_wrong} wrong elements, max|err| "
              f"{int(diff.abs().max())}", flush=True)
        if n_wrong:
            t = gram_tri.tiling(dtype, n, torch.cuda.get_device_properties(0).multi_processor_count)
            tm, tn = t.tile_m, t.tile_n
            rr, cc = torch.nonzero(diff, as_tuple=True)
            tiles = sorted({(int(a), int(b)) for a, b in zip((rr // tm).tolist(), (cc // tn).tolist())})
            print(f"  {len(tiles)} wrong tiles of {tm}x{tn}: {tiles[:24]}{' ...' if len(tiles) > 24 else ''}")
            print("  first wrong (row, col, kernel, exact): " + ", ".join(
                f"({r}, {c}, {int(K[r, c])}, {int(L[r, c])})" for r, c in zip(rr[:6].tolist(), cc[:6].tolist())))
            for i, j in tiles[:4]:
                print("  " + explain_tile(D, diff, i, j, tm, tn, S), flush=True)
        return n_wrong == 0
    X = torch.rand((n, p), device="cuda", generator=gen).to(dtype)
    K, R = gram_tri.gram_tri_float(X), gram_tri.gram_tri_float_plain(X)
    torch.cuda.synchronize()
    err, scale = float((K - R).abs().max()), float(R.abs().max())
    print(f"K2 {label}: max|err|/max|G| {err / scale:.3g}", flush=True)
    return err <= K2_TOL * scale


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", action="append", help="dtype:NxP, repeatable")
    ap.add_argument("--repeat", type=int, default=1, help="runs of each shape, seeds 0, 1, ...")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    ok = True
    for spec in args.shape or DEFAULT_SHAPES:
        for seed in range(args.repeat):
            ok &= check(*parse(spec), seed)
            torch.cuda.empty_cache()
    print("all equal" if ok else "MISMATCH")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
