#!/usr/bin/env python3
"""How the precision of a fold GRM's eigendecomposition moves gblup's REML, on one card.

Usage, from the root of a checkout, on a machine with one CUDA card:

    python3 scripts/torch_gblup_fold_eigh.py

It builds the jobs of `chip_smoke.py` phase 10 (a): `simulate_genomes(n=256,
l=2048, seed=5)` called to {0, 1/2, 1}, `cvbulk` fold labels for 1x3 folds
from seed 7. For each training fold it forms the simple GRM (K1 on the card)
and eigendecomposes it four ways: f32 on the card, f64 on the card, f32 on
the CPU and f64 on the CPU. It prints each spectrum's largest distance from
the CPU's f64 one over max|K|, and, from each decomposition, REML's
(sigma2_e, sigma2_u) on the CPU and the validation y_pred's largest distance
from the f64 CPU one over std(y). It imports neither jax nor the JAX package.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import genomicbreedingmodels_tpu_torch as gbm  # noqa: E402
from genomicbreedingmodels_tpu_torch.core.grm import grm_simple  # noqa: E402
from genomicbreedingmodels_tpu_torch.cv import harness  # noqa: E402
from genomicbreedingmodels_tpu_torch.models.gblup import reml_variance_components  # noqa: E402
from genomicbreedingmodels_tpu_torch.prediction import extractxyetc  # noqa: E402


def gblup_from_eig(X, y, K, denom, eig):
    """gblup's REML and marker effects (models/gblup.py) from a given eigh."""
    s, U = eig
    se, su = reml_variance_components(y, K, eig=eig, device="cpu")
    d = np.maximum(su * s + se, 1e-12)
    alpha = U @ ((U.T @ (y - y.mean())) / d)
    b = (su / denom) * ((X - X.mean(axis=0)).T @ alpha)
    return se, su, float(y.mean() - X.mean(axis=0) @ b), b


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    g = gbm.simulate_genomes(n=256, l=2048, seed=5)
    trials, _ = gbm.simulate_trials(g, f_add_dom_epi=np.array([[0.4, 0.05, 0.05]]), seed=5)
    ph = gbm.extract_phenomes(trials)
    g = gbm.Genomes(entries=g.entries, populations=g.populations, loci_alleles=g.loci_alleles,
                    allele_frequencies=np.rint(2.0 * g.allele_frequencies) / 2.0)
    sd = float(np.std(ph.phenotypes[:, 0]))
    jobs, _ = harness._cvbulk_jobs(g, ph, ["gblup"], 1, 3, 7)
    for job in jobs:
        X, y, e, pops, la = extractxyetc(g, ph, idx_entries=job["idx_training"], add_intercept=False)
        grm = grm_simple(gbm.Genomes(entries=e, populations=pops, loci_alleles=la, allele_frequencies=X),
                         device="cuda")
        K = grm.genomic_relationship_matrix.double()
        K = (K + K.T) / 2.0
        Kh = K.cpu().numpy()
        eigs = {}
        for where, Kt in (("card", K), ("cpu", K.cpu())):
            for dt in (torch.float32, torch.float64):
                s, U = torch.linalg.eigh(Kt.to(dt))
                eigs[f"{where} {str(dt)[6:]}"] = (np.maximum(s.double().cpu().numpy(), 0.0),
                                                  U.double().cpu().numpy())
        ref_s = eigs["cpu float64"][0]
        Xv = g.allele_frequencies[job["idx_validation"]]
        fits = {k: gblup_from_eig(X, y, Kh, grm.denominator, eig) for k, eig in eigs.items()}
        ref_pred = fits["cpu float64"][2] + Xv @ fits["cpu float64"][3]
        print(f"{job['fold']}: {len(y)} training entries, max|K| {np.abs(Kh).max():.4g}")
        for k, (se, su, b0, b) in fits.items():
            ds = np.abs(eigs[k][0] - ref_s).max() / np.abs(Kh).max()
            dp = np.abs(b0 + Xv @ b - ref_pred).max() / sd
            print(f"  eigh {k:13s}: max|Δs|/max|K| {ds:.3g}  sigma2_e {se:.6g} sigma2_u {su:.6g}  "
                  f"max|Δ y_pred|/sd {dp:.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
