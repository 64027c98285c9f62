#!/usr/bin/env python3
"""How far `gblup_multienv`'s variance components move when its GRM moves by
the size of an f32 Gram's rounding, and which of the card's and the CPU's
fits an all-f64 fit agrees with.

Usage, from the root of a checkout (on the CPU, or with a CUDA card):

    python3 scripts/torch_multienv_grm_sensitivity.py [--n-perturb 3]

It simulates `chip_smoke.py` phase 12 (d)'s trial set (simulate_genomes
2048x16384 seed 42; 3 years x 2 sites x 2 replications, seed 5) and fits
`gblup_multienv` with device="cpu": first the witness
(`chip_smoke.multienv_f64_witness`: the GRM an f64 product of the centred
panel on the host, its eigendecomposition in f64, where the port's CPU path
rounds the GRM to f32 and eigendecomposes in f32); then each half of it
alone (the f64 GRM with the f32 eigh, the GRM as built with the f64 eigh)
and the witness with its REML scan in f64; then the CPU fit as built; then the CPU fit on the GRM plus a symmetric Gaussian perturbation
of 3e-6·max|K| per seed, the size of K2's f32 distance from the plain f64
Gram (`chip_smoke.py` phase 3).
With a card it also fits on the card, as built. Each line gives σ²ᵤ, σ²ₑ and
σ²_env and their relative distance from the witness. It imports neither jax
nor the JAX package.
"""

from __future__ import annotations

import argparse
import importlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import genomicbreedingmodels_tpu_torch as gbm  # noqa: E402
from chip_smoke import multienv_f64_witness  # noqa: E402

mt = importlib.import_module("genomicbreedingmodels_tpu_torch.models.multitrait")
gwas = importlib.import_module("genomicbreedingmodels_tpu_torch.models.gwas")
reml_variance_components = mt.reml_variance_components
COMPS = ("sigma2_u", "sigma2_e", "sigma2_env")
REL = 3e-6


def reml_f64_scan(y, K, eig, device="cpu"):
    """`reml_variance_components` with its REML scan in f64 (the port's runs
    the scan in f32), on a given eigendecomposition."""
    y = np.asarray(y, dtype=np.float64)
    sd = y.std(ddof=1)
    s, U = (torch.as_tensor(a, dtype=torch.float64) for a in eig)
    kscale = float(torch.as_tensor(K, dtype=torch.float64).diagonal().mean())
    yt = U.T @ torch.from_numpy((y - y.mean()) / sd)
    _, theta = gwas._reml_scan(yt, U.sum(dim=0)[None, :, None], s / kscale)
    th = theta[0].numpy()
    return float(th[0] * sd**2), float(th[1] * sd**2 / kscale)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-perturb", type=int, default=3)
    args = ap.parse_args()
    if torch.cuda.is_available():
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip())
    g = gbm.simulate_genomes(n=2048, l=16_384, seed=42)
    pv = np.array([[0.5], [0.2], [0.0], [0.1], [0.0], [0.0], [0.0], [0.0]])
    trials, _ = gbm.simulate_trials(g, n_years=3, n_sites=2, n_replications=2,
                                    f_add_dom_epi=np.array([[0.5, 0.0, 0.0]]),
                                    proportion_of_variance=pv, seed=5)
    grm_of_type = mt.grm_of_type

    def fit(label, device="cpu"):
        e = gbm.gblup_multienv(g, trials, device=device).extras
        return label, {k: e[k] for k in COMPS}

    rows = []
    for label, grm, eigh in (("cpu, f64 GRM and f64 eigh (witness)", True, True),
                             ("cpu, f64 GRM, f32 eigh", True, False),
                             ("cpu, GRM as built, f64 eigh", False, True)):
        e = multienv_f64_witness(gbm, g, trials, grm=grm, eigh=eigh).extras
        rows.append((label, {k: e[k] for k in COMPS}))
    mt.reml_variance_components = reml_f64_scan
    try:
        e = multienv_f64_witness(gbm, g, trials).extras
    finally:
        mt.reml_variance_components = reml_variance_components
    rows.append(("witness with an f64 REML scan", {k: e[k] for k in COMPS}))
    rows.append(fit("cpu, GRM as built"))
    for seed in range(1, args.n_perturb + 1):
        def perturbed(*a, _seed=seed, **kw):
            r = grm_of_type(*a, **kw)
            K = r.genomic_relationship_matrix
            N = torch.randn(K.shape, generator=torch.Generator().manual_seed(_seed), dtype=K.dtype)
            r.genomic_relationship_matrix = K + REL * K.abs().max() * (N + N.T).to(K.device) / 2.0
            return r

        mt.grm_of_type = perturbed
        try:
            rows.append(fit(f"cpu, GRM + {REL:g}·max|K| noise, seed {seed}"))
        finally:
            mt.grm_of_type = grm_of_type
    if torch.cuda.is_available():
        rows.append(fit("card, GRM as built", "cuda"))
    base = rows[0][1]
    for label, comps in rows:
        print(f"{label:40s} " + " ".join(
            f"{k} {v:.7g} ({abs(v - base[k]) / abs(base[k]):.2e})" for k, v in comps.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
