#!/usr/bin/env python3
"""Time the port's Gram kernels (K1, K2) against an earlier build of them, on one card.

Usage, from the root of a checkout, on a machine with one NVIDIA Hopper card:

    python3 scripts/torch_gram_before_after.py --before DIR

DIR holds earlier `gram_tri_int8.cu` / `gram_tri_float.cu` sources (and any
header they include) with the same C entry points
(`gbm_gram_tri_int8/_f32/_bf16`), for example written by
`git show <commit>:genomicbreedingmodels_tpu_torch/csrc/gram_tri_int8.cu`
into a git-ignored directory under `build/`. They are compiled with the
port's nvcc flags into their own library under `build/gram_before/`, and
loaded beside the current kernels. At each timed shape (K1 8192x262144 and
1844x16384 int8, K2 1844x16384 and 2048x32768 in f32 and bf16) the script
checks that both builds give the same Gram (K1 bit-equal, K2 within
1e-5·max|G| of each other), then times them by CUDA events in turns
(before, after, after, before, ... for `--rounds` rounds) beside the one
PyTorch call that computes the same function (none for K1 where n % 8,
which `torch._int_mm` refuses), and gives each K2 build's max |err| /
max|G| against a float64 product. It prints the card's name and power
limit, one line per shape, and a JSON line. It imports neither jax nor the
JAX package.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SHAPES = [("int8", 8192, 262_144), ("int8", 1844, 16_384), ("float32", 1844, 16_384),
          ("bfloat16", 1844, 16_384),
          ("float32", 2048, 32_768), ("bfloat16", 2048, 32_768)]


def build_before(src: Path) -> ctypes.CDLL:
    """The earlier sources, compiled as the port compiles its own."""
    from genomicbreedingmodels_tpu_torch.kernels import _build

    saved = _build.CSRC, _build.BUILD_DIR
    _build.CSRC, _build.BUILD_DIR = src, ROOT / "build" / "gram_before"
    try:
        lib = ctypes.CDLL(str(_build.build()))
    finally:
        _build.CSRC, _build.BUILD_DIR = saved
    for name in ("gbm_gram_tri_int8", "gbm_gram_tri_f32", "gbm_gram_tri_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = list(_build._ENTRY_POINTS[name])
        fn.restype = ctypes.c_int
    return lib


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--before", type=Path, required=True, help="directory of the earlier .cu sources")
    ap.add_argument("--reps", type=int, default=10, help="launches per timing (half for int8)")
    ap.add_argument("--shape", action="append", metavar="DTYPE:NxP",
                    help="time only these shapes, e.g. int8:8192x262144 (default: all)")
    ap.add_argument("--rounds", type=int, default=2,
                    help="timing rounds per build, in turns: before, after, after, before, ...")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs one CUDA card", file=sys.stderr)
        return 1

    from genomicbreedingmodels_tpu_torch.kernels import gram_tri

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    before = build_before(args.before.resolve())
    entry = {"int8": "gbm_gram_tri_int8", "float32": "gbm_gram_tri_f32", "bfloat16": "gbm_gram_tri_bf16"}

    def old(X):
        out = torch.zeros((X.shape[0],) * 2, device=X.device,
                          dtype=torch.int32 if X.dtype == torch.int8 else torch.float32)
        rc = getattr(before, entry[str(X.dtype)[6:]])(
            X.data_ptr(), out.data_ptr(), X.shape[0], X.shape[1], torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"earlier kernel launch failed: cudaError {rc}")
        return out

    def new(X):
        return gram_tri.gram_tri_int8(X) if X.dtype == torch.int8 else gram_tri.gram_tri_float(X)

    def library(X):
        if X.dtype == torch.int8:
            return torch._int_mm(X, X.t())  # n % 8 == 0 only
        if X.dtype == torch.bfloat16:
            try:
                return torch.mm(X, X.T, out_dtype=torch.float32)
            except (TypeError, RuntimeError):
                return torch.mm(X, X.T)
        return torch.mm(X, X.T)

    def ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    shapes = [s for s in SHAPES if not args.shape or f"{s[0]}:{s[1]}x{s[2]}" in args.shape]
    for dt, n, p in shapes:
        if dt == "int8":
            X = torch.randint(0, 3, (n, p), dtype=torch.int8, device="cuda", generator=gen)
        else:
            X = torch.rand((n, p), device="cuda", generator=gen).to(getattr(torch, dt))
        A, B = old(X), new(X)
        torch.cuda.synchronize()
        err = {}
        if dt == "int8":
            same = bool(torch.equal(A, B))
        else:
            same = float((A - B).abs().max()) <= 1e-5 * float(A.abs().max())
            R = gram_tri.gram_tri_float_plain(X)  # float64 product
            scale = float(R.abs().max())
            err = {"before_rel_err": float((A - R).abs().max()) / scale,
                   "after_rel_err": float((B - R).abs().max()) / scale}
            del R
        del A, B
        reps = max(2, args.reps // 2) if dt == "int8" else args.reps
        t = {"before": [], "after": []}
        for r in range(args.rounds):
            for which in ("before", "after") if r % 2 == 0 else ("after", "before"):
                t[which].append(ms(lambda: (old if which == "before" else new)(X), reps))
        lib_ms = None if dt == "int8" and n % 8 else ms(lambda: library(X), reps)
        row = dict(shape=f"{n}x{p}", dtype=dt, agree=same, before_ms=t["before"],
                   after_ms=t["after"], library_ms=lib_ms, **err)
        rows.append(row)
        errs = "".join(f", {k} {v:.3g}" for k, v in err.items())
        fmt = lambda v: " / ".join(f"{x:.4f}" for x in v)  # noqa: E731
        print(f"{dt} {n}x{p}: before {fmt(t['before'])} ms, after {fmt(t['after'])} ms, "
              f"library {lib_ms} ms, agree={same}{errs} [{smi}]", flush=True)
        del X
        torch.cuda.empty_cache()
    print(json.dumps({"card": smi, "rows": rows}))
    return 0 if all(r["agree"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
