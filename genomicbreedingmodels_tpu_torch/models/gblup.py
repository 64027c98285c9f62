"""GBLUP: GRM-based mixed-model genomic prediction with REML variance
components, torch port of genomicbreedingmodels_tpu/models/gblup.py.

The GRM (K1 or K2), its one eigendecomposition and the REML scan run on
`device` (the eigendecomposition through the port's one policy,
`ops/linalg.py:_eigh_device`: f64 on the card, f32 on the CPU). `gblup`'s
marker effects are f64 numpy on the host, as in the JAX package;
`gblup_multitrait`, which fits every complete-record trait from one GRM and
one eigendecomposition, keeps the basis and the panel on the device and
forms its n×n and n×p products there in f64. Marker effects come from the
RR-BLUP equivalence b = (σ²ᵤ/c) Zᵀ (σ²ᵤK + σ²ₑI)⁻¹ y_c (c = GRM
denominator), so a returned Fit predicts new entries through the ordinary
`predict` GEMV path.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.grm import grm_of_type
from ..core.structs import Fit, Genomes, Phenomes
from ..device import as_tensor, resolve_device
from ..ops.metrics import metrics
from ..prediction import extractxyetc
from ..ops.linalg import _eigh_device
from .gwas import _reml_scan

__all__ = ["gblup", "gblup_multitrait", "reml_variance_components"]


def _eigh_sym(Ksym: torch.Tensor):
    """Eigendecomposition on Ksym's device through `_eigh_device`; f64 numpy
    (s, U) for the host-side effect math."""
    s, U = _eigh_device(Ksym)
    return s.double().cpu().numpy(), U.double().cpu().numpy()


def _stage_clock(dev: torch.device):
    """(stages, mark): mark(name) stores under `name` the wall seconds since
    the previous mark (or this call), after a synchronise on the card."""
    stages, last = {}, [time.perf_counter()]

    def mark(name: str) -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        stages[name] = now - last[0]
        last[0] = now

    return stages, mark


def _effects(X: torch.Tensor, W: torch.Tensor, denom: float):
    """(B, x̄): the RR-BLUP marker effects B = ZᵀW / denom of the centred
    panel Z = X − 1x̄ᵀ, W (n, t), on X's device in X's dtype, Z never formed
    (ZᵀW = XᵀW − x̄·1ᵀW)."""
    xbar = X.mean(dim=0)
    return (X.T @ W - xbar[:, None] * W.sum(dim=0)) / denom, xbar


def reml_variance_components(
    y: np.ndarray, K, eig=None, device="cuda"
) -> Tuple[float, float]:
    """REML (σ²_e, σ²_u) for y = 1μ + u + e, u ~ N(0, σ²_u K).

    y is standardized internally so the reference bounds [eps, 1]² apply; the
    components are returned on the original scale of y. `eig=(s, U)` reuses a
    precomputed eigendecomposition of the symmetrized K (numpy or tensors).
    """
    dev = resolve_device(device)
    y = np.asarray(y, dtype=np.float64)
    sd = y.std(ddof=1)
    ys = (y - y.mean()) / sd
    K = as_tensor(K, dev, torch.float64)
    s, U = eig if eig is not None else _eigh_device(K)
    s, U = as_tensor(s, dev, torch.float64), as_tensor(U, dev, torch.float64)
    # Normalize K scale so σ²_u is per unit diagonal (the symmetrised K's
    # diagonal is K's own).
    kscale = float(K.diagonal().mean())
    kscale = kscale if kscale > 1e-12 else 1.0
    yt = (U.T @ as_tensor(ys, dev, torch.float64)).float()
    ones_t = U.sum(dim=0).float()[:, None]  # Uᵀ1
    _, theta = _reml_scan(yt, ones_t[None, :, :], (s / kscale).float())
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
    stages, _stage = _stage_clock(dev)
    X, y, entries, populations, loci_alleles = extractxyetc(
        genomes, phenomes, idx_entries=idx_entries, idx_loci_alleles=idx_loci_alleles,
        idx_trait=idx_trait, add_intercept=False,
    )
    _stage("extract")
    grm = grm_of_type(X, GRM_type, dev)
    K, denom = grm.genomic_relationship_matrix.double(), grm.denominator
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


def gblup_multitrait(
    genomes: Genomes,
    phenomes: Phenomes,
    idx_entries: Optional[Sequence[int]] = None,
    idx_loci_alleles: Optional[Sequence[int]] = None,
    GRM_type: str = "simple",
    verbose: bool = False,
    device="cuda",
) -> list:
    """GBLUP for every trait, one Fit per trait in the order of
    `phenomes.traits`.

    Traits with complete records on the selected entries share one GRM and
    one eigendecomposition: each then costs one single-design REML scan and
    two products with the basis, and all their marker effects come from one
    n×p product. A trait with missing records is fitted alone by `gblup` on
    its own entries. Each Fit carries σ²ₑ, σ²ᵤ and h² in `extras`.
    """
    if not genomes.checkdims():
        raise ValueError("the Genomes struct is corrupted")
    if not phenomes.checkdims():
        raise ValueError("the Phenomes struct is corrupted")
    dev = resolve_device(device)
    idx_e = np.arange(genomes.n) if idx_entries is None else np.asarray(idx_entries)
    phi_all = phenomes.phenotypes[idx_e]
    complete = np.flatnonzero(np.all(np.isfinite(phi_all), axis=0)).tolist()
    fits = {}
    if complete:
        X, _, entries, populations, loci_alleles = extractxyetc(
            genomes, phenomes, idx_entries=idx_entries, idx_loci_alleles=idx_loci_alleles,
            idx_trait=complete[0], add_intercept=False, copy=False,
        )
        grm = grm_of_type(X, GRM_type, dev)
        K, denom = grm.genomic_relationship_matrix.double(), grm.denominator
        s, U = _eigh_device((K + K.T) / 2.0)
        kdiag = float(K.diagonal().mean())
        Y = np.asarray(phenomes.phenotypes[np.ix_(idx_e, complete)], dtype=np.float64)
        Ut_yc = U.T @ as_tensor(Y - Y.mean(axis=0), dev, torch.float64)  # every trait rotated at once
        comps, alphas = [], []
        for j in range(len(complete)):
            sigma2_e, sigma2_u = reml_variance_components(Y[:, j], K, eig=(s, U), device=dev)
            comps.append((sigma2_e, sigma2_u))
            d = torch.clamp(sigma2_u * s + sigma2_e, min=1e-12)
            alphas.append(sigma2_u * (U @ (Ut_yc[:, j] / d)))
        Xd = as_tensor(X, dev, torch.float64)
        B, xbar = _effects(Xd, torch.stack(alphas, dim=1), denom)
        b0 = as_tensor(Y.mean(axis=0), dev, torch.float64) - xbar @ B
        Y_pred = (b0 + Xd @ B).cpu().numpy()
        B, b0 = B.cpu().numpy(), b0.cpu().numpy()
        del Xd
        labels = np.concatenate([np.asarray(["intercept"], dtype=object), loci_alleles])
        for j, t in enumerate(complete):
            sigma2_e, sigma2_u = comps[j]
            h2 = (sigma2_u * kdiag / (sigma2_u * kdiag + sigma2_e)
                  if (sigma2_u + sigma2_e) > 0 else 0.0)
            fit = Fit(
                model="gblup",
                b_hat=np.concatenate([[b0[j]], B[:, j]]),
                b_hat_labels=labels,
                trait=str(phenomes.traits[t]),
                entries=entries,
                populations=populations,
                y_true=Y[:, j],
                y_pred=Y_pred[:, j],
                metrics=metrics(Y[:, j], Y_pred[:, j]),
                extras={"sigma2_e": sigma2_e, "sigma2_u": sigma2_u, "h2": h2,
                        "grm_type": GRM_type},
            )
            if not fit.checkdims():
                raise RuntimeError("error fitting multitrait gblup")
            fits[t] = fit
    for t in range(phenomes.t):
        if t not in fits:
            fits[t] = gblup(genomes, phenomes, idx_entries=idx_entries,
                            idx_loci_alleles=idx_loci_alleles, idx_trait=t,
                            GRM_type=GRM_type, verbose=verbose, device=dev)
    return [fits[t] for t in range(phenomes.t)]
