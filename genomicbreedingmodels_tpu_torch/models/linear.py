"""Direct linear genomic-prediction models: OLS, ridge (RR-BLUP), LASSO.

Torch port of genomicbreedingmodels_tpu/models/linear.py, with API parity to
reference src/linear.jl (`ols` :54-103, `ridge` :162-239, `lasso` :302-378):
every model takes (genomes, phenomes, idx_entries, idx_loci_alleles,
idx_trait) keywords and `device=`, and returns a populated Fit. The solves
are `ops/linalg.py`'s on `device`: ridge's Gram is K2 on bf16 operands.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..core.structs import Fit, Genomes, Phenomes
from ..ops import linalg
from ..ops.metrics import metrics
from ..prediction import extractxyetc

__all__ = ["ols", "ridge", "lasso"]


def _assemble_fit(model, b_hat, loci_alleles, trait, entries, populations, y, y_pred, extras=None) -> Fit:
    fit = Fit(
        model=model,
        b_hat=b_hat,
        b_hat_labels=np.concatenate([np.asarray(["intercept"], dtype=object), loci_alleles]),
        trait=str(trait),
        entries=entries,
        populations=populations,
        y_true=y,
        y_pred=y_pred,
        metrics=metrics(y, y_pred),
        extras=extras or {},
    )
    if not fit.checkdims():
        raise RuntimeError(f"error fitting {model}")
    return fit


def ols(
    genomes: Genomes,
    phenomes: Phenomes,
    idx_entries: Optional[Sequence[int]] = None,
    idx_loci_alleles: Optional[Sequence[int]] = None,
    idx_trait: int = 0,
    verbose: bool = False,
    device="cuda",
) -> Fit:
    """Ordinary least squares with intercept (reference src/linear.jl:54-103).

    Wide panels use the min-norm dual solve (one n×n eigh and two GEMMs).
    """
    X, y, entries, populations, loci_alleles = extractxyetc(
        genomes, phenomes, idx_entries=idx_entries, idx_loci_alleles=idx_loci_alleles,
        idx_trait=idx_trait, add_intercept=True,
    )
    b_hat = linalg.lstsq_minnorm(X, y, device=device)
    y_pred = X @ b_hat
    return _assemble_fit("ols", b_hat, loci_alleles, phenomes.traits[idx_trait], entries, populations, y, y_pred)


def ridge(
    genomes: Genomes,
    phenomes: Phenomes,
    idx_entries: Optional[Sequence[int]] = None,
    idx_loci_alleles: Optional[Sequence[int]] = None,
    idx_trait: int = 0,
    n_lambda: int = 100,
    lambda_min_ratio: float = 0.01,
    n_folds: int = 10,
    seed: int = 42,
    verbose: bool = False,
    device="cuda",
) -> Fit:
    """Ridge / RR-BLUP with CV-selected λ (reference src/linear.jl:162-239)."""
    X, y, entries, populations, loci_alleles = extractxyetc(
        genomes, phenomes, idx_entries=idx_entries, idx_loci_alleles=idx_loci_alleles,
        idx_trait=idx_trait, add_intercept=False,
    )
    b0, beta, info = linalg.ridge_cv_path(
        X, y, n_lambda=n_lambda, lambda_min_ratio=lambda_min_ratio, n_folds=n_folds, seed=seed,
        device=device,
    )
    b_hat = np.concatenate([[b0], beta])
    y_pred = b0 + X @ beta
    return _assemble_fit(
        "ridge", b_hat, loci_alleles, phenomes.traits[idx_trait], entries, populations, y, y_pred,
        extras={"lambda": float(info["lambdas"][info["chosen"]])},
    )


def lasso(
    genomes: Genomes,
    phenomes: Phenomes,
    idx_entries: Optional[Sequence[int]] = None,
    idx_loci_alleles: Optional[Sequence[int]] = None,
    idx_trait: int = 0,
    n_lambda: int = 100,
    lambda_min_ratio: float = 0.01,
    n_folds: int = 10,
    seed: int = 42,
    n_iter: int = 400,
    verbose: bool = False,
    device="cuda",
) -> Fit:
    """LASSO with CV-selected λ (reference src/linear.jl:302-378)."""
    X, y, entries, populations, loci_alleles = extractxyetc(
        genomes, phenomes, idx_entries=idx_entries, idx_loci_alleles=idx_loci_alleles,
        idx_trait=idx_trait, add_intercept=False,
    )
    b0, beta, info = linalg.lasso_cv_path(
        X, y, n_lambda=n_lambda, lambda_min_ratio=lambda_min_ratio, n_folds=n_folds,
        seed=seed, n_iter=n_iter, device=device,
    )
    b_hat = np.concatenate([[b0], beta])
    y_pred = b0 + X @ beta
    return _assemble_fit(
        "lasso", b_hat, loci_alleles, phenomes.traits[idx_trait], entries, populations, y, y_pred,
        extras={"lambda": float(info["lambdas"][info["chosen"]])},
    )
