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
from the f64 CPU one over std(y).

Then it traces the remaining card-against-CPU gap of `gblup` (its σ² and
y_pred): on each fold, and on `chip_smoke.py` phase 6's continuous training
panel (1843x16384), it runs REML's `_reml_scan` on ONE basis, the card's f64
eigendecomposition, in f32 and in f64, on the card and on the CPU, beside
what `gblup` itself runs on each side (card: f64 basis, f32 scan; CPU: f32
basis, f32 scan), and then `gblup` + `predict` themselves on each side
(each building its own GRM). Each line gives σ²ₑ, σ²ᵤ and the validation
y_pred's largest distance over std(y) from the f64 basis + f64 scan on the
CPU. It imports neither jax nor the JAX package.
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
from genomicbreedingmodels_tpu_torch.models.gwas import _reml_scan  # noqa: E402
from genomicbreedingmodels_tpu_torch.prediction import extractxyetc  # noqa: E402


def gblup_from_eig(X, y, K, denom, eig):
    """gblup's REML and marker effects (models/gblup.py) from a given eigh."""
    s, U = eig
    se, su = reml_variance_components(y, K, eig=eig, device="cpu")
    d = np.maximum(su * s + se, 1e-12)
    alpha = U @ ((U.T @ (y - y.mean())) / d)
    b = (su / denom) * ((X - X.mean(axis=0)).T @ alpha)
    return se, su, float(y.mean() - X.mean(axis=0) @ b), b


def reml_scan_in(y, K, eig, dev, dtype):
    """`reml_variance_components` with its scan in `dtype` on `dev`."""
    s, U = eig
    sd = y.std(ddof=1)
    ys = (y - y.mean()) / sd
    kscale = float(np.mean(np.diag(K)))
    yt = torch.tensor(U.T @ ys, dtype=dtype, device=dev)
    ones_t = torch.tensor(U.T @ np.ones(len(y)), dtype=dtype, device=dev)[:, None]
    _, th = _reml_scan(yt, ones_t[None], torch.tensor(s / kscale, dtype=dtype, device=dev))
    th = th[0].double().cpu().numpy()
    return float(th[0] * sd**2), float(th[1] * sd**2 / kscale)


def trace_scan(label, X, y, Xv, K, denom, eigs, sd):
    """The C.2 trace on one training set: REML scan precision and device on
    the card's f64 basis, against gblup's own two paths."""
    def effects(se, su, eig):
        s, U = eig
        d = np.maximum(su * s + se, 1e-12)
        b = (su / denom) * ((X - X.mean(axis=0)).T @ (U @ ((U.T @ (y - y.mean())) / d)))
        return float(y.mean() - X.mean(axis=0) @ b) + Xv @ b

    basis = eigs["card float64"]
    runs = {}
    for where in ("cuda", "cpu"):
        for dt in (torch.float32, torch.float64):
            runs[f"f64 basis, {str(dt)[6:]} scan on {where}"] = (reml_scan_in(y, K, basis, where, dt), basis)
    runs["gblup card: f64 basis, f32 scan"] = runs["f64 basis, float32 scan on cuda"]
    runs["gblup cpu: cpu f32 basis, f32 scan"] = (
        reml_scan_in(y, K, eigs["cpu float32"], "cpu", torch.float32), eigs["cpu float32"])
    ref = effects(*runs["f64 basis, float64 scan on cpu"][0], basis)
    print(f"  C.2 trace, {label}:")
    for k, ((se, su), eig) in runs.items():
        dp = np.abs(effects(se, su, eig) - ref).max() / sd
        print(f"    {k:36s}: sigma2_e {se:.7g} sigma2_u {su:.7g}  max|Δ y_pred|/sd vs f64/f64 {dp:.3g}")
    return ref


def trace_entry(g, ph, idx_training, idx_validation, ref, sd):
    """`gblup` and `predict` on the card and on the CPU against the trace's
    f64/f64 validation y_pred."""
    for where in ("cuda", "cpu"):
        fit = gbm.gblup(g, ph, idx_entries=idx_training, device=where)
        dp = np.abs(gbm.predict(fit, g, idx_validation, device=where) - ref).max() / sd
        ex = fit.extras
        print(f"    {'gblup + predict on ' + where:36s}: sigma2_e {ex['sigma2_e']:.7g} "
              f"sigma2_u {ex['sigma2_u']:.7g}  max|Δ y_pred|/sd vs f64/f64 {dp:.3g}")


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
        ref = trace_scan(job["fold"], X, y, Xv, Kh, grm.denominator, eigs, sd)
        trace_entry(g, ph, job["idx_training"], job["idx_validation"], ref, sd)

    # chip_smoke.py phase 6's continuous panel and 90 % training split
    g6 = gbm.simulate_genomes(n=2048, l=16_384, seed=42)
    t6, _ = gbm.simulate_trials(g6, f_add_dom_epi=np.array([[0.4, 0.05, 0.05]]), seed=42)
    ph6 = gbm.extract_phenomes(t6)
    perm = np.random.default_rng(7).permutation(g6.n)
    test, train = np.sort(perm[: g6.n // 10]), np.sort(perm[g6.n // 10 :])
    X, y, e, pops, la = extractxyetc(g6, ph6, idx_entries=train, add_intercept=False)
    grm = grm_simple(gbm.Genomes(entries=e, populations=pops, loci_alleles=la, allele_frequencies=X),
                     device="cuda")
    K = grm.genomic_relationship_matrix.double()
    K = (K + K.T) / 2.0
    eigs = {}
    for where, Kt in (("card", K), ("cpu", K.cpu())):
        for dt in (torch.float32, torch.float64):
            sv, Uv = torch.linalg.eigh(Kt.to(dt))
            eigs[f"{where} {str(dt)[6:]}"] = (np.maximum(sv.double().cpu().numpy(), 0.0), Uv.double().cpu().numpy())
    sd6 = float(np.std(ph6.phenotypes[:, 0]))
    ref = trace_scan(f"phase 6 continuous, {len(y)} training entries", X, y, g6.allele_frequencies[test],
                     K.cpu().numpy(), grm.denominator, eigs, sd6)
    trace_entry(g6, ph6, train, test, ref, sd6)
    return 0


if __name__ == "__main__":
    sys.exit(main())
