"""Genomic relationship matrices (GRM/kinship), torch port.

Port of genomicbreedingmodels_tpu/core/grm.py (GenomicBreedingCore's
`grmsimple` / `grmploidyaware`). The centered Gram runs on `device` through
ops/grm.py: exact int8 dosages (K1) for panels on the genotype grid, f32
(K2) otherwise. The GRM stays on the device as an f32 tensor.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.grm import encode_dosage, gram_centered, gram_dosage
from .structs import Genomes

__all__ = ["GRMResult", "GRM_TYPES", "grm_simple", "grm_ploidy_aware", "grm_of_type", "infer_ploidy"]

GRM_TYPES = ("simple", "ploidy-aware")


@dataclass
class GRMResult:
    genomic_relationship_matrix: torch.Tensor  # (n, n) f32, on the device it was built on
    denominator: float
    ploidy: int


def _grm_from_freqs(freqs: np.ndarray, ploidy: int, device) -> GRMResult:
    X = np.asarray(freqs, dtype=np.float64)
    if not np.all(np.isfinite(X)):
        n_bad = int(X.size - np.count_nonzero(np.isfinite(X)))
        raise ValueError(
            f"the allele-frequency panel contains {n_bad} missing/non-finite "
            "values; impute first (e.g. prediction.mean_impute) — a NaN panel "
            "silently poisons the Gram product"
        )
    col_mean = X.mean(axis=0)
    # VanRaden-style denominator: ploidy * sum_j fbar_j (1 - fbar_j).
    denom = float(ploidy) * float(np.sum(col_mean * (1.0 - col_mean)))
    if denom <= 1e-12:
        denom = 1.0
    D = encode_dosage(X, ploidy=ploidy)
    if D is not None:
        G = gram_dosage(D, ploidy=ploidy, device=device) / denom
    else:
        G = gram_centered(X, device=device) / denom
    return GRMResult(genomic_relationship_matrix=G, denominator=denom, ploidy=ploidy)


def grm_simple(genomes: Genomes, device="cuda") -> GRMResult:
    """Simple (diploid-assumption) GRM: centered X Xᵀ / (2 Σ f̄(1-f̄))."""
    return _grm_from_freqs(genomes.allele_frequencies, ploidy=2, device=device)


def infer_ploidy(freqs: np.ndarray) -> int:
    """Infer ploidy as round(1 / min nonzero frequency) (reference src/gwas.jl:119).

    Continuous simulated frequencies can be arbitrarily close to 0 (where the
    reference's rule would return round(1/eps)); the result is clamped to
    [1, 100] so a single near-zero frequency cannot produce a nonsensical or
    non-finite ploidy.
    """
    nz = freqs[np.isfinite(freqs) & (freqs != 0.0)]
    if len(nz) == 0:
        return 2
    m = float(np.min(np.abs(nz)))
    if m < 0.01:  # 1/m > 100: not a plausible ploidy — cap
        return 100
    return max(1, int(round(1.0 / m)))


def grm_ploidy_aware(genomes: Genomes, ploidy: int = 2, device="cuda") -> GRMResult:
    """Ploidy-aware GRM: centered X Xᵀ / (ploidy Σ f̄(1-f̄))."""
    return _grm_from_freqs(genomes.allele_frequencies, ploidy=ploidy, device=device)


def grm_of_type(freqs: np.ndarray, GRM_type: str = "simple", device="cuda") -> GRMResult:
    """The GRM of panel `freqs` (n, p) that `GRM_type` names: "simple", or
    "ploidy-aware" with the ploidy inferred from the panel (`infer_ploidy`)."""
    if GRM_type == "ploidy-aware":
        return _grm_from_freqs(freqs, ploidy=infer_ploidy(np.asarray(freqs)), device=device)
    if GRM_type == "simple":
        return _grm_from_freqs(freqs, ploidy=2, device=device)
    raise ValueError(f"unrecognised GRM_type {GRM_type!r}; choose from {GRM_TYPES}")
