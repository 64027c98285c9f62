"""Design-matrix extraction and genomic prediction.

Port of genomicbreedingmodels_tpu/prediction.py, which mirrors reference
src/prediction.jl: `extractxyetc` (:53-139) and `predict` (:189-235), with
integer-index fast paths replacing the reference's per-call string lookups.
`mean_impute` and `extractxyetc` are numpy and copied as they are; `predict`
runs its GEMV on `device`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from .core.structs import Fit, Genomes, Phenomes
from .ops.linalg import affine_predict

__all__ = ["extractxyetc", "predict", "mean_impute", "LINEAR_MODELS", "NON_LINEAR_MODELS"]


def mean_impute(G: np.ndarray) -> np.ndarray:
    """Column-mean-impute missing/non-finite panel values (copy).

    All-missing columns get 0.5 (the allele-frequency midpoint) so they stay
    zero-variance and are dropped by downstream variance filters.
    """
    G = np.array(G, dtype=np.float64, copy=True)
    bad = ~np.isfinite(G)
    if bad.any():
        import warnings

        with np.errstate(invalid="ignore"), warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN columns
            col_mean = np.nanmean(np.where(bad, np.nan, G), axis=0)
        col_mean = np.where(np.isfinite(col_mean), col_mean, 0.5)
        G[bad] = np.broadcast_to(col_mean, G.shape)[bad]
    return G

LINEAR_MODELS = (
    "ols", "ridge", "lasso", "bayesa", "bayesb", "bayesc",
    "bayesian_ridge", "bayesian_lasso", "bayesian_lasso_pi",
    "bayest", "bayestpi", "gblup",
)
NON_LINEAR_MODELS = ("mlp",)


def _check_idx(idx, upper: int, what: str) -> np.ndarray:
    idx = np.asarray(idx, dtype=np.int64)
    if len(idx) and (idx.min() < 0 or idx.max() >= upper):
        raise IndexError(
            f"the indexes of the {what} are out of bounds: expected range 0..{upper - 1}, "
            f"got {idx.min()}..{idx.max()}"
        )
    return idx


def extractxyetc(
    genomes: Genomes,
    phenomes: Phenomes,
    idx_entries: Optional[Sequence[int]] = None,
    idx_loci_alleles: Optional[Sequence[int]] = None,
    idx_trait: int = 0,
    add_intercept: bool = True,
    impute_missing: Optional[str] = None,
    copy: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Extract (X, y, entries, populations, loci_alleles) for one trait.

    Drops entries with missing/NaN/Inf phenotypes, requires >= 2 survivors and
    trait variance >= 1e-20 (reference src/prediction.jl:114-127). Indices are
    0-based (the reference is 1-based Julia).

    Missing GENOTYPES are a hard error by default: the reference assumes an
    imputed panel (its external core imputes upstream), and a NaN column
    silently poisons every downstream GEMM. Pass `impute_missing="mean"` to
    column-mean-impute the sliced panel in place of erroring (all-missing
    columns become their 0.5 midpoint).

    `copy=False` (internal fast path for READ-ONLY consumers, e.g. the GWAS
    device prep) returns X as a VIEW of `genomes.allele_frequencies` when
    the selection covers the whole panel in natural order and no intercept
    column is prepended — skipping a panel-sized host copy (~1-2 s at
    2048×32768 f64 on a 2-core host). The caller must not mutate X.
    """
    if not genomes.checkdims():
        raise ValueError("the Genomes struct is corrupted")
    if not phenomes.checkdims():
        raise ValueError("the Phenomes struct is corrupted")
    if not np.array_equal(genomes.entries, phenomes.entries):
        raise ValueError("genomes and phenomes must be merged to have consistent entries")
    idx_e = np.arange(genomes.n) if idx_entries is None else _check_idx(idx_entries, genomes.n, "entries")
    idx_l = (
        np.arange(genomes.p)
        if idx_loci_alleles is None
        else _check_idx(idx_loci_alleles, genomes.p, "loci_alleles")
    )
    if not (0 <= idx_trait < phenomes.t):
        raise IndexError(f"idx_trait {idx_trait} out of bounds for {phenomes.t} traits")

    phi = phenomes.phenotypes[idx_e, idx_trait]
    keep = np.flatnonzero(np.isfinite(phi))
    if len(keep) < 2:
        raise ValueError("fewer than 2 entries with non-missing phenotype data")
    y = phi[keep]
    if np.var(y, ddof=1) < 1e-20:
        raise ValueError(f"very low or zero variance in trait: {phenomes.traits[idx_trait]!r}")
    rows = idx_e[keep]
    full_panel = (
        len(rows) == genomes.n
        and len(idx_l) == genomes.p
        and np.array_equal(rows, np.arange(genomes.n))
        and np.array_equal(idx_l, np.arange(genomes.p))
    )
    if not copy and full_panel and not add_intercept:
        G = genomes.allele_frequencies  # view; caller contract: read-only
    else:
        G = genomes.allele_frequencies[np.ix_(rows, idx_l)]
    if not np.all(np.isfinite(G)):
        if impute_missing == "mean":
            if G is genomes.allele_frequencies:
                G = G.copy()  # never impute into the caller's panel
            G = mean_impute(G)
        else:
            n_bad = int(np.size(G) - np.count_nonzero(np.isfinite(G)))
            raise ValueError(
                f"the genotype panel contains {n_bad} missing/non-finite values; "
                "impute upstream or pass impute_missing='mean'"
            )
    entries = genomes.entries[rows]
    populations = genomes.populations[rows]
    loci_alleles = genomes.loci_alleles[idx_l]
    if add_intercept:
        X = np.concatenate([np.ones((len(keep), 1)), G], axis=1)
    else:
        X = G
    return X, y, entries, populations, loci_alleles


def predict(
    fit: Fit, genomes: Genomes, idx_entries: Sequence[int], device="cuda"
) -> np.ndarray:
    """ŷ = b₀ + X[idx, model-loci] · b (reference src/prediction.jl:225-228),
    one f32 GEMV on `device`; for an MLP fit, the network's forward pass on
    `device`."""
    if not fit.checkdims():
        raise ValueError("the Fit struct is corrupted")
    if not genomes.checkdims():
        raise ValueError("the Genomes struct is corrupted")
    idx_e = _check_idx(idx_entries, genomes.n, "entries")
    try:
        idx_l = genomes.locus_indices(fit.b_hat_labels[1:].tolist())
    except KeyError:
        raise ValueError(
            "the loci-alleles in the fitted model do not match the loci-alleles in the "
            "requested validation set; the genomes struct may have more loci-alleles than "
            "the fitted model, but all model loci-alleles must be present"
        ) from None
    if fit.model in LINEAR_MODELS:
        return affine_predict(
            genomes.allele_frequencies, idx_e, idx_l, float(fit.b_hat[0]), fit.b_hat[1:],
            device=device,
        )
    if fit.model in NON_LINEAR_MODELS:
        from .models.mlp import mlp_predict_from_fit

        G = genomes.allele_frequencies[np.ix_(idx_e, idx_l)]
        return mlp_predict_from_fit(fit, G, device=device)
    raise ValueError(f"unrecognised genomic prediction model: {fit.model!r}")
