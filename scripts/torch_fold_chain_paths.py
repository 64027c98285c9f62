#!/usr/bin/env python3
"""Time the fold chains' within-block paths at the JAX bench's `cv` cell, on one card.

Usage, from the root of a checkout, on a machine with one NVIDIA card:

    python3 scripts/torch_fold_chain_paths.py [--sweeps 20] [--rounds 2]

`gibbs_cv_folds` on the `cv` cell's panel (2048 x 32768 from rng(11), as
`chip_smoke.cv_cell` builds it) with the 15 training masks of
`cvbulk_batched(n_replications=3, n_folds=5)`, for `--sweeps` sweeps each:

- BRR with its joint block draw in the step (the gate lowered below the
  15 · 128 · 256² table floats for the call: per block a batched Cholesky,
  solve and triangular solve) and hoisted (the gate raised for the call:
  one batched factorization a sweep, two products a block), in turns
  (in-step, hoisted, hoisted, in-step, ...);
- BL (the single-pattern group solve, hoisted tables) and BayesC (K3, one
  launch a block for all 15 folds), once per round.

It prints the card's name and power limit, seconds per sweep for each path
and round, and the largest difference of the two BRR paths' posterior means
(the same draws, so only rounding), and a JSON line. It imports neither jax
nor the JAX package.
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweeps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs one CUDA card", file=sys.stderr)
        return 1

    import genomicbreedingmodels_tpu_torch as gbm
    from chip_smoke import cv_cell

    bayes = importlib.import_module("genomicbreedingmodels_tpu_torch.models.bayesian")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    G, P = cv_cell(gbm, 2048, 32_768)
    n = G.n
    rng = np.random.default_rng(42)  # cvbulk_batched's default seed: its fold labels
    masks = []
    for _ in range(3):
        labels = rng.integers(1, 6, size=n)
        masks += [(labels != j).astype(np.float32) for j in range(1, 6)]
    masks = np.stack(masks)
    X = torch.as_tensor(G.allele_frequencies, device="cuda")
    y = P.phenotypes[:, 0]
    gate = bayes._JOINT_TABLE_FLOATS

    def run(model, hoist=False):
        bayes._JOINT_TABLE_FLOATS = int(4e8) if hoist else int(1e8)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mu, b = gbm.gibbs_cv_folds(X, y, masks, model=model, n_iter=args.sweeps,
                                       n_burnin=args.sweeps // 2, seed=1, device="cuda")
            t = (time.perf_counter() - t0) / args.sweeps
        finally:
            bayes._JOINT_TABLE_FLOATS = gate
        return t, b

    run("BRR")  # warm-up: cuSOLVER and cuBLAS handles, the allocator
    rows = {"BRR in-step": [], "BRR hoisted": [], "BL": [], "BayesC": []}
    diff = 0.0
    for r in range(args.rounds):
        order = [False, True] if r % 2 == 0 else [True, False]
        for hoist in order:
            t, b = run("BRR", hoist)
            rows["BRR hoisted" if hoist else "BRR in-step"].append(t)
            if hoist:
                b_h = b
            else:
                b_s = b
        diff = max(diff, float(np.abs(b_h - b_s).max() / np.abs(b_s).max()))
        rows["BL"].append(run("BL")[0])
        rows["BayesC"].append(run("BayesC")[0])
    for name, ts in rows.items():
        print(f"{name}: " + " / ".join(f"{t:.4f}" for t in ts)
              + f" s per sweep, 15 folds at 2048x32768 [{smi}]")
    print(f"BRR hoisted against in-step: max |Δ b| / max |b| = {diff:.3g} (same draws) [{smi}]")
    print(json.dumps({"card": smi, "sweeps": args.sweeps, "s_per_sweep": rows, "brr_rel_diff": diff}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
