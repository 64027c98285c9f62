#!/usr/bin/env python3
"""Time the port's K3 (the grouped Gibbs block update) against an earlier build of it, on one card.

Usage, from the root of a checkout, on a machine with one NVIDIA Hopper card:

    python3 scripts/torch_gibbs_before_after.py --before DIR [--before DIR2 ...]

Each DIR holds an earlier `gibbs_group.cu` with the C entry point
`gbm_gibbs_group`, for example written by
`git show <commit>:genomicbreedingmodels_tpu_torch/csrc/gibbs_group.cu` into a
git-ignored directory under `build/`. A source whose entry point takes no
workspace (the one-CTA kernel of the first port) is called as such; one that
takes a workspace (tables, flags, epoch, slice, staged columns) gets the
current wrapper's `k3_layout` and a workspace of its own, and one with a fold
axis (its entry point takes `folds` and fold strides) is called with one
fold. Each is compiled with the port's nvcc flags into its own library under
`build/gibbs_before/<DIR name>/`. The `after` row goes through the port's
wrapper and carries its host time; pass the current
`genomicbreedingmodels_tpu_torch/csrc` as a `--before` too to time the
current kernel through the same bare call as the earlier builds.

At each shape (`--shape bs:K`, default 600:6 and 600:8, the chain's block at
K=6 and 8) the script draws one block as the chain hands it to K3 (Cb and u
of a random centered dosage panel, sparse effects, the noise), holds every
build against the plain version (identical selections, draws within
1e-4·max(1, max|b|)) and says whether its outputs are bit-equal to the
current build's, then times the builds by CUDA events in turns (before,
after, after, before, ... for `--rounds` rounds), each with Cb cold in L2
(after overwriting 64 MB, less the time of that overwrite), as the chain
finds it, and warm. It prints the card's name and power limit, one line per
shape and build, and a JSON line; it exits 1 if a build disagrees. It imports
neither jax nor the JAX package.
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

_P, _S = ctypes.c_void_p, ctypes.c_longlong
_ABIS = {  # the entry point's arguments in each generation of the kernel
    "one-CTA": (_P,) * 12 + (_S, _S, _P),
    "workspace": (_P,) * 12 + (_S, _S, _P, _P, _S, _S, _S, _P),
    "folds": (_P,) * 12 + (_S, _S, _P, _P) + (_S,) * 10 + (_P,),
}


def build_before(src: Path):
    """(entry point, its ABI) of the earlier source, compiled as the port compiles its own."""
    from genomicbreedingmodels_tpu_torch.kernels import _build

    saved = _build.CSRC, _build.BUILD_DIR
    _build.CSRC, _build.BUILD_DIR = src, ROOT / "build" / "gibbs_before" / src.name
    try:
        lib = ctypes.CDLL(str(_build.build()))
    finally:
        _build.CSRC, _build.BUILD_DIR = saved
    text = (src / "gibbs_group.cu").read_text()
    abi = "folds" if "cb_fs" in text else "workspace" if "epoch" in text else "one-CTA"
    fn = lib.gbm_gibbs_group
    fn.argtypes = list(_ABIS[abi])
    fn.restype = ctypes.c_int
    return fn, abi


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--before", type=Path, action="append", required=True,
                    help="directory of an earlier gibbs_group.cu (repeatable)")
    ap.add_argument("--shape", action="append", metavar="BS:K",
                    help="block size and group size, e.g. 600:6 (default: 600:6 and 600:8)")
    ap.add_argument("--reps", type=int, default=50, help="launches per timing")
    ap.add_argument("--rounds", type=int, default=2,
                    help="timing rounds per build, in turns: before, after, after, before, ...")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs one CUDA card", file=sys.stderr)
        return 1

    from chip_smoke import cuda_ms, k3_inputs
    from genomicbreedingmodels_tpu_torch.kernels import gibbs_group

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    builds = {"after": None}
    for d in args.before:
        builds[f"before:{d.name}"] = build_before(d.resolve())

    spaces = {}

    def run(which, a, K):
        if builds[which] is None:
            return gibbs_group.grouped_block_update(*a, K=K)
        fn, abi = builds[which]
        bs = a[0].shape[0]
        out = [torch.empty(bs, device=a[0].device) for _ in range(3)]
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [t.data_ptr() for t in (*a, *out)]
        if abi == "one-CTA":
            rc = fn(*ptrs, bs, K, stream)
        else:  # its own workspace: one flag per group covers any flag layout
            lay = gibbs_group.k3_layout(bs, K)
            ws = spaces.get((which, bs, K))
            if ws is None:
                ws = spaces[(which, bs, K)] = [
                    torch.empty(lay.table_floats, device=a[0].device),
                    torch.zeros(lay.groups, dtype=torch.int32, device=a[0].device), 0]
            ws[2] = gibbs_group.next_epoch(ws[2])
            one_fold = (1, 0, 0, 0, 0, 0, 0) if abi == "folds" else ()
            rc = fn(*ptrs, bs, K, ws[0].data_ptr(), ws[1].data_ptr(), ws[2], lay.slice_floats,
                    lay.staged_quads, *one_fold, stream)
        if rc:
            raise RuntimeError(f"{which}: launch failed, cudaError {rc}")
        return out

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(2**24, device=dev)  # 64 MB, beyond the 50 MB L2
    flush_ms = cuda_ms(flush.zero_, reps=50)
    rows, agree_all = [], True
    shapes = [tuple(map(int, s.split(":"))) for s in (args.shape or ["600:6", "600:8"])]
    for bs, K in shapes:
        a = k3_inputs(dev, gen, bs, K)
        d_p, b_p, incl_p = gibbs_group.grouped_block_update_plain(*a, K=K)
        tol = 1e-4 * max(1.0, float(b_p.abs().max()))
        t = {w: {"cold": [], "warm": []} for w in builds}
        agree, same = {}, {}
        now = run("after", a, K)
        for w in builds:
            d, b, incl = run(w, a, K)
            torch.cuda.synchronize()
            agree[w] = bool(torch.equal(incl, incl_p)) and float((b - b_p).abs().max()) <= tol
            same[w] = all(torch.equal(x, y) for x, y in zip((d, b, incl), now))
            agree_all &= agree[w]
        order = list(builds)
        for r in range(args.rounds):
            for w in order if r % 2 == 0 else order[::-1]:
                t[w]["cold"].append(cuda_ms(lambda: (flush.zero_(), run(w, a, K)), args.reps) - flush_ms)
                t[w]["warm"].append(cuda_ms(lambda: run(w, a, K), args.reps))
        G = bs // K
        for w in builds:
            fmt = lambda v: " / ".join(f"{x:.4f}" for x in v)  # noqa: E731
            print(f"bs={bs} K={K} {w}: cold {fmt(t[w]['cold'])} ms "
                  f"({min(t[w]['cold']) / G * 1e3:.3f} us per group), warm {fmt(t[w]['warm'])} ms, "
                  f"agrees with plain={agree[w]}, bit-equal to after={same[w]} [{smi}]", flush=True)
            rows.append(dict(bs=bs, K=K, build=w, cold_ms=t[w]["cold"], warm_ms=t[w]["warm"],
                             agree=agree[w], bit_equal_to_after=same[w]))
    print(json.dumps({"card": smi, "rows": rows}))
    return 0 if agree_all else 1


if __name__ == "__main__":
    sys.exit(main())
