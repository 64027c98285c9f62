#!/usr/bin/env python3
"""How the precision of the CV paths' batched eigendecompositions moves their
predictions, on one card.

Usage, from the root of a checkout, on a machine with one CUDA card:

    python3 scripts/torch_cv_fold_eigh.py

It builds the JAX bench's `cv` cell as `chip_smoke.py` phase 10 (b) does: a
2048x32768 uniform panel from default_rng(11), 1 % causal markers, 3x5 folds
drawn as `cvbulk_batched` draws them. Then, each call site in f32 (as the
port runs it) and in f64:

1. `cv/batched.py:_masked_eigh`, the batched eigh of the 15 masked fold
   Grams (15 x 2048²) behind `cvbulk_batched`'s ridge and gblup: each
   fold's spectrum distance from f64 over max|K|, the chosen λ (ridge) and
   variance ratio (gblup), and the validation y_pred's largest distance
   from the f64 one over std(y); the solve's time in each precision;
2. `ops/linalg.py:_ridge_folds_fromgram` (the 10 inner folds' masked
   Grams) and `_ridge_full_eigh` (the full training Gram), the two eighs of
   `ridge_cv_path` that `cvbulk`'s ridge runs per fold: the chosen λ and
   the outer validation y_pred's distance over std(y), for the first outer
   fold of replication 1;
3. `ops/linalg.py:_lstsq_dual` (OLS) through `_eigh_device`: f64 on the
   card, f32 on the CPU; its validation y_pred at 256x2048 called, per fold
   of `cvbulk`, card against CPU and each against an f64 numpy min-norm
   `lstsq` of the same fold, over std(y).

A call site switches to f64 only where its y_pred moves by more than
1e-4·std(y). It imports neither jax nor the JAX package.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import genomicbreedingmodels_tpu_torch as gbm  # noqa: E402
from genomicbreedingmodels_tpu_torch.cv import batched  # noqa: E402
from genomicbreedingmodels_tpu_torch.ops import linalg  # noqa: E402

EIGH = torch.linalg.eigh


def eigh_f64(A):
    """torch.linalg.eigh computed in f64, returned in A's dtype."""
    s, U = EIGH(A.double())
    return s.to(A.dtype), U.to(A.dtype)


def in_f64(fn, *args):
    """fn(*args) with every torch.linalg.eigh it calls computed in f64."""
    torch.linalg.eigh = eigh_f64
    try:
        return fn(*args)
    finally:
        torch.linalg.eigh = EIGH


def timed(fn, *args):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def cv_cell(n=2048, p=32_768):
    rng = np.random.default_rng(11)
    freq = rng.uniform(size=(n, p)).astype(np.float32)
    beta = rng.normal(size=p) * (rng.uniform(size=p) < 0.01)
    y = freq @ beta
    y = y + rng.normal(size=n) * y.std()
    folds = np.random.default_rng(42)
    W, V = [], []
    for _ in range(3):
        labels = folds.integers(1, 6, size=n)
        for j in range(1, 6):
            W.append(labels != j)
            V.append(labels == j)
    return freq, y, np.stack(W).astype(np.float32), np.stack(V)


def masked_folds(dev, freq, y, W, V, sd):
    X = torch.from_numpy(freq).to(dev)
    K, _ = batched._gram(X)
    yt = torch.from_numpy(y.astype(np.float32)).to(dev)
    Wt = torch.from_numpy(W).to(dev)
    n_w, _, s32, _, _ = batched._masked_eigh(K, yt, Wt)
    _, _, s64, _, _ = in_f64(batched._masked_eigh, K, yt, Wt)
    Kmax = float(K.abs().max())
    ds = ((s32 - s64).abs().amax(dim=1) / Kmax).cpu().numpy()
    print(f"(1) cv/batched.py:_masked_eigh, 15 x {K.shape[0]}²: max|Δs|/max|K| per fold "
          f"f32 vs f64: max {ds.max():.3g}, median {np.median(ds):.3g}")
    tr_scale = float(K.diagonal().sum()) / K.shape[0]
    for kind, grid_np in (("ridge", np.logspace(-4, 1, 12)),
                          ("gblup", tr_scale * np.logspace(-3.0, 3.0, 13))):
        grid = torch.tensor(grid_np, dtype=torch.float32, device=dev)
        (p32, _, c32), t32 = timed(batched._solve_folds, K, yt, Wt, grid, kind)
        (p64, _, c64), t64 = timed(in_f64, batched._solve_folds, K, yt, Wt, grid, kind)
        b32, b64 = c32.argmin(1), c64.argmin(1)
        f = np.arange(len(b32))
        dy = np.array([np.abs(p32[i, b32[i]] - p64[i, b64[i]])[V[i]].max() for i in f]) / sd
        dy_same = np.array([np.abs(p32[i, b64[i]] - p64[i, b64[i]])[V[i]].max() for i in f]) / sd
        print(f"    {kind}: chosen index differs in {int((b32 != b64).sum())} of {len(f)} folds; "
              f"validation max|Δ y_pred|/sd per fold: max {dy.max():.3g}, median {np.median(dy):.3g} "
              f"(at f64's choice: max {dy_same.max():.3g}); _solve_folds f32 {t32:.3f} s, "
              f"f64 {t64:.3f} s")


def ridge_path(dev, freq, y, W, V, sd):
    tr, va = np.flatnonzero(W[0]), np.flatnonzero(V[0])
    X, yy = freq[tr], y[tr]
    out = {}
    for label, fn in (("f32", lambda: linalg.ridge_cv_path(X, yy, device=dev)),
                      ("f64", lambda: in_f64(linalg.ridge_cv_path, X, yy, None, None, None, 42, dev))):
        (b0, beta, info), t = timed(fn)
        out[label] = (b0 + freq[va] @ beta, info["chosen"], t)
    dy = np.abs(out["f32"][0] - out["f64"][0]).max() / sd
    print(f"(2) ops/linalg.py ridge_cv_path ({len(tr)} training rows, 10 inner folds): chosen λ "
          f"index f32 {out['f32'][1]}, f64 {out['f64'][1]}; validation max|Δ y_pred|/sd {dy:.3g}; "
          f"f32 {out['f32'][2]:.3f} s, f64 {out['f64'][2]:.3f} s")


def ols_folds(dev):
    g = gbm.simulate_genomes(n=256, l=2048, seed=5)
    trials, _ = gbm.simulate_trials(g, f_add_dom_epi=np.array([[0.4, 0.05, 0.05]]), seed=5)
    ph = gbm.extract_phenomes(trials)
    g = gbm.Genomes(entries=g.entries, populations=g.populations, loci_alleles=g.loci_alleles,
                    allele_frequencies=np.rint(2.0 * g.allele_frequencies) / 2.0)
    sd = float(np.std(ph.phenotypes[:, 0]))
    runs = {d: gbm.cvbulk(g, ph, models=["ols"], n_replications=1, n_folds=3, seed=7, device=d)[0]
            for d in (dev, "cpu")}
    y = ph.phenotypes[:, 0]
    X = np.hstack([np.ones((g.n, 1)), g.allele_frequencies])
    rows = {"card vs cpu": [], "card vs f64 lstsq": [], "cpu vs f64 lstsq": []}
    for a, b in zip(runs[dev], runs["cpu"]):
        va = g.entry_indices(a.validation_entries.tolist())
        tr = np.setdiff1d(np.arange(g.n), va)
        ref = X[va] @ np.linalg.lstsq(X[tr], y[tr], rcond=None)[0]
        for key, (u, v) in (("card vs cpu", (a.y_pred, b.y_pred)), ("card vs f64 lstsq", (a.y_pred, ref)),
                            ("cpu vs f64 lstsq", (b.y_pred, ref))):
            rows[key].append(float(np.abs(u - v).max()) / sd)
    print("(3) ops/linalg.py:_lstsq_dual (OLS) through _eigh_device, 256x2048 called, 1x3 folds, "
          "max|Δ y_pred|/sd per fold: "
          + "; ".join(f"{k} " + " ".join(f"{d:.3g}" for d in v) for k, v in rows.items()))


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    dev = torch.device("cuda")
    freq, y, W, V = cv_cell()
    sd = float(np.std(y))
    masked_folds(dev, freq, y, W, V, sd)
    ridge_path(dev, freq, y, W, V, sd)
    ols_folds(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
