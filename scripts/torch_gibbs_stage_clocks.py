#!/usr/bin/env python3
"""Cycle marks along K3's group loop (the grouped Gibbs block update), on one card.

Usage, from the root of a checkout, on a machine with one NVIDIA Hopper card:

    python3 scripts/torch_gibbs_stage_clocks.py [--shape BS:K ...]

The script writes a copy of `csrc/gibbs_group.cu` under the git-ignored
`build/gibbs_stage_clocks/`, with `clock64()` marks inserted: on lane 0 of the
scan warp after v is formed and broadcast, after the patterns are scored,
after the argmax, and after the group's record is written; on the first
update thread after the coming item's copies are issued, after the rank-K
update, and after the next item has landed; and after the group's closing
barrier. Each mark is the SM's cycle count since the group's opening
barrier, written to a debug area behind the workspace's tables (the copy
writes no delta). It builds that copy with the port's nvcc flags, runs it
on one block as the chain hands it to K3 (`chip_smoke.k3_inputs`, Cb cold
in L2), and prints for each shape the median of each mark over the groups
(the first three and the last two left out), with the SM clock under a
stream of K3 launches (`nvidia-smi --query-gpu=clocks.sm`). The marks
themselves order the instructions around them, so they are an upper bound
on each stage. It imports neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

MARKS = ["v", "scored", "argmax", "recorded", "issued", "updated", "landed", "barrier"]

# (anchor in the kernel source, text put after it); each anchor occurs once.
PROBES = [
    ("  for (int g = 0; g < G; ++g) {\n",
     "    const long long t_top = clock64();\n"),
    ("      issue(g + D);\n",
     "      if (tid == WARP) dbg[4 * G + g] = (float)(clock64() - t_top);\n"),
    ("      landed(g + 1);\n",
     "      if (tid == WARP) dbg[6 * G + g] = (float)(clock64() - t_top);\n"),
    ("      for (int i = 0; i < K; ++i) v[i] = __shfl_sync(FULL, vi, i);\n",
     "      if (lane == 0) dbg[g] = (float)(clock64() - t_top);\n"),
    ("      const unsigned key = score_key(best);\n",
     "      if (lane == 0) dbg[G + g] = (float)(clock64() - t_top);\n"),
    ("      const int win = bw == INT_MAX ? 0 : bw;  // all scores NaN: pattern 0\n",
     "      if (lane == 0) dbg[2 * G + g] = (float)(clock64() - t_top);\n"),
]
# (anchor, text put before it)
PROBES_BEFORE = [
    ("      landed(g + 1);\n",
     "      if (tid == WARP) dbg[5 * G + g] = (float)(clock64() - t_top);\n"),
    ("  const float inv_sig = 1.f / *a.sig_e2;\n",
     "  float* dbg = a.tables + static_cast<long long>(G) * slice;  // 8·G floats behind the tables\n"),
]
# (old, new) replacements
SWAPS = [
    ("    __syncthreads();\n  }\n  if (ut >= 0 && ut < 3 * K)",
     "    if (lane == 0) dbg[3 * G + g] = (float)(clock64() - t_top);\n"
     "    __syncthreads();\n    if (tid == 0) dbg[7 * G + g] = (float)(clock64() - t_top);\n"
     "  }\n  if (ut >= 0 && ut < 3 * K)"),
]


def instrumented_source() -> str:
    src = (ROOT / "genomicbreedingmodels_tpu_torch" / "csrc" / "gibbs_group.cu").read_text()
    for anchor, text in PROBES:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once in gibbs_group.cu: {anchor!r}")
        src = src.replace(anchor, anchor + text)
    for anchor, text in PROBES_BEFORE:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once in gibbs_group.cu: {anchor!r}")
        src = src.replace(anchor, text + anchor)
    for old, new in SWAPS:
        if src.count(old) != 1:
            raise RuntimeError(f"anchor not found once in gibbs_group.cu: {old!r}")
        src = src.replace(old, new)
    return src


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", action="append", metavar="BS:K",
                    help="block size and group size (default: 600:6 and 600:8)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs one CUDA card", file=sys.stderr)
        return 1

    from chip_smoke import k3_inputs
    from genomicbreedingmodels_tpu_torch.kernels import gibbs_group
    from torch_gibbs_before_after import build_before

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    out_dir = ROOT / "build" / "gibbs_stage_clocks"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "gibbs_group.cu").write_text(instrumented_source())
    fn, abi = build_before(out_dir)
    one_fold = (1, 0, 0, 0, 0, 0, 0) if abi == "folds" else ()  # folds and their strides
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(2**24, device=dev)  # 64 MB, beyond the 50 MB L2
    for bs, K in [tuple(map(int, s.split(":"))) for s in (args.shape or ["600:6", "600:8"])]:
        a = k3_inputs(dev, gen, bs, K)
        G = bs // K
        lay = gibbs_group.k3_layout(bs, K)
        tables = torch.zeros(lay.table_floats + 8 * G, device=dev)
        flags = torch.zeros(lay.builders, dtype=torch.int32, device=dev)
        out = [torch.zeros(bs, device=dev) for _ in range(3)]
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [t.data_ptr() for t in (*a, *out)]

        def launch(epoch, cold=True):
            if cold:
                flush.zero_()
            rc = fn(*ptrs, bs, K, tables.data_ptr(), flags.data_ptr(), epoch, lay.slice_floats,
                    lay.staged_quads, *one_fold, stream)
            if rc:
                raise RuntimeError(f"launch failed: cudaError {rc}")

        for epoch in range(1, 4):
            launch(epoch)
        torch.cuda.synchronize()
        marks = tables[lay.table_floats:].view(8, G)[:, 3:G - 2].median(dim=1).values.tolist()
        for epoch in range(4, 3000):  # a stream of launches to read the clock under
            launch(epoch, cold=False)
        clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                               capture_output=True, text=True).stdout.strip()
        torch.cuda.synchronize()
        print(f"bs={bs} K={K} cycles since the group's barrier (median over groups): "
              + ", ".join(f"{m} {v:.0f}" for m, v in zip(MARKS, marks))
              + f"; SM clock under K3 launches {clock} [{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
