"""GBLUP: GRM-based mixed-model genomic prediction with REML variance
components, torch port of genomicbreedingmodels_tpu/models/gblup.py.

The GRM (K1 or K2), its one eigendecomposition and the REML scan run in f32
on `device` (the eigendecomposition in f64 on the card, see `_eigh_sym`);
the marker effects are f64 numpy on the host, as in the JAX package. Marker effects come from the RR-BLUP equivalence
b = (σ²ᵤ/c) Zᵀ (σ²ᵤK + σ²ₑI)⁻¹ y_c (c = GRM denominator), so the returned Fit
predicts new entries through the ordinary `predict` GEMV path.
`gblup_multitrait` waits for the multi-trait slice.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.grm import grm_ploidy_aware, grm_simple, infer_ploidy
from ..core.structs import Fit, Genomes, Phenomes
from ..device import as_tensor, resolve_device
from ..ops.metrics import metrics
from ..prediction import extractxyetc
from .gwas import _eigh_device, _reml_scan

__all__ = ["gblup", "reml_variance_components"]


def _eigh_sym(Ksym: torch.Tensor):
    """Eigendecomposition on Ksym's device; f64 numpy (s, U) for the
    host-side effect math.

    f32 on the CPU, as the JAX package. On the card it runs in f64: on an
    H100 the f32 spectra of 162-183-entry fold GRMs were up to 6.7e-4·max|K|
    off the f64 ones (the CPU's f32 spectra 3.4e-6·max|K|), and on the
    162-entry fold REML's σ²ₑ, which lives on the small eigenvalues, moved
    by 25 % (`scripts/torch_gblup_fold_eigh.py`)."""
    dtype = torch.float64 if Ksym.device.type == "cuda" else torch.float32
    s, U = _eigh_device(Ksym.to(dtype))
    return s.double().cpu().numpy(), U.double().cpu().numpy()


def reml_variance_components(
    y: np.ndarray, K, eig=None, device="cuda"
) -> Tuple[float, float]:
    """REML (σ²_e, σ²_u) for y = 1μ + u + e, u ~ N(0, σ²_u K).

    y is standardized internally so the reference bounds [eps, 1]² apply; the
    components are returned on the original scale of y. `eig=(s, U)` reuses a
    precomputed eigendecomposition of the symmetrized K.
    """
    dev = resolve_device(device)
    y = np.asarray(y, dtype=np.float64)
    sd = y.std(ddof=1)
    ys = (y - y.mean()) / sd
    K = as_tensor(K, dev, torch.float64)
    Ksym = (K + K.T) / 2.0
    s, U = eig if eig is not None else _eigh_sym(Ksym)
    # Normalize K scale so σ²_u is per unit diagonal.
    kscale = float(Ksym.diagonal().mean())
    kscale = kscale if kscale > 1e-12 else 1.0
    yt = as_tensor(U.T @ ys, dev, torch.float32)
    ones_t = as_tensor((U.T @ np.ones(len(y)))[:, None], dev, torch.float32)
    _, theta = _reml_scan(yt, ones_t[None, :, :], as_tensor(s / kscale, dev, torch.float32))
    th = theta[0].double().cpu().numpy()
    var = sd**2
    return float(th[0] * var), float(th[1] * var / kscale)


def gblup(
    genomes: Genomes,
    phenomes: Phenomes,
    idx_entries: Optional[Sequence[int]] = None,
    idx_loci_alleles: Optional[Sequence[int]] = None,
    idx_trait: int = 0,
    GRM_type: str = "simple",
    verbose: bool = False,
    device="cuda",
) -> Fit:
    """Fit GBLUP; returns a Fit whose b_hat are RR-BLUP-equivalent marker
    effects (so `predict` works unchanged), with REML variance components,
    h² and the wall seconds of each stage in `fit.extras`."""
    dev = resolve_device(device)
    stages = {}
    t0 = time.perf_counter()

    def _stage(name):
        nonlocal t0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        stages[name] = t1 - t0
        t0 = t1

    X, y, entries, populations, loci_alleles = extractxyetc(
        genomes, phenomes, idx_entries=idx_entries, idx_loci_alleles=idx_loci_alleles,
        idx_trait=idx_trait, add_intercept=False,
    )
    sub = Genomes(
        entries=entries, populations=populations, loci_alleles=loci_alleles,
        allele_frequencies=X,
    )
    _stage("extract")
    if GRM_type == "ploidy-aware":
        grm = grm_ploidy_aware(sub, ploidy=infer_ploidy(X), device=dev)
    elif GRM_type == "simple":
        grm = grm_simple(sub, device=dev)
    else:
        raise ValueError(f"unrecognised GRM_type {GRM_type!r}")
    K = grm.genomic_relationship_matrix.to(torch.float64)
    denom = grm.denominator
    _stage("grm")

    s, U = _eigh_sym((K + K.T) / 2.0)  # one decomposition, shared with REML
    _stage("eigh")
    sigma2_e, sigma2_u = reml_variance_components(y, K, eig=(s, U), device=dev)
    kdiag = float(K.diagonal().mean())
    h2 = sigma2_u * kdiag / (sigma2_u * kdiag + sigma2_e) if (sigma2_u + sigma2_e) > 0 else 0.0
    _stage("reml")

    # Marker effects via the eigenbasis: alpha = (σ²ᵤK + σ²ₑI)⁻¹ y_c.
    yc = y - y.mean()
    d = sigma2_u * s + sigma2_e
    d[d < 1e-12] = 1e-12
    alpha = U @ ((U.T @ yc) / d)
    Z = X - X.mean(axis=0, keepdims=True)
    b = (sigma2_u / denom) * (Z.T @ alpha)
    b0 = float(y.mean() - X.mean(axis=0) @ b)
    b_hat = np.concatenate([[b0], b])
    y_pred = b0 + X @ b
    _stage("effects")

    fit = Fit(
        model="gblup",
        b_hat=b_hat,
        b_hat_labels=np.concatenate([np.asarray(["intercept"], dtype=object), loci_alleles]),
        trait=str(phenomes.traits[idx_trait]),
        entries=entries,
        populations=populations,
        y_true=y,
        y_pred=y_pred,
        metrics=metrics(y, y_pred),
        extras={
            "sigma2_e": sigma2_e,
            "sigma2_u": sigma2_u,
            "h2": h2,
            "grm_type": GRM_type,
            "stage_seconds": stages,
        },
    )
    if not fit.checkdims():
        raise RuntimeError("error fitting gblup")
    return fit
