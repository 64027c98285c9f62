"""Core data model: Genomes, Phenomes, Trials, SimulatedEffects, Fit, CV.

Copied from genomicbreedingmodels_tpu/core/structs.py (numpy only, so the
port never imports the JAX package). Design differences from the reference
data layer (GenomicBreedingCore.jl):

- Numeric payloads (`allele_frequencies`, `phenotypes`) are dense float arrays
  (numpy on host; converted to torch tensors on the requested device at the
  model boundary).
- String metadata (entries, populations, loci_alleles, traits) lives host-side
  in numpy object arrays; name->index resolution happens once via hash maps
  instead of the reference's repeated O(n*m) linear scans
  (reference src/cross_validation.jl:162-165).
- Missing phenotypes are encoded as NaN (the reference uses Julia `missing`;
  its extraction path drops missing/NaN/Inf identically, reference
  src/prediction.jl:116).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

import numpy as np

__all__ = [
    "Genomes",
    "Phenomes",
    "Trials",
    "SimulatedEffects",
    "Fit",
    "CV",
    "checkdims",
    "slice_genomes",
    "slice_phenomes",
    "clone",
]


def _as_str_array(x: Sequence[str]) -> np.ndarray:
    return np.asarray(list(x), dtype=object)


def _as_float_matrix(x) -> np.ndarray:
    a = np.asarray(x, dtype=np.float64)
    if a.ndim != 2:
        raise ValueError(f"expected a 2-D matrix, got shape {a.shape}")
    return a


@dataclass
class Genomes:
    """n entries x p loci-alleles allele-frequency matrix with metadata.

    Mirrors the capability of GenomicBreedingCore's `Genomes` struct as used by
    the reference (fields inferred at reference src/transformation.jl:166-172,
    640-644): entries, populations, loci_alleles, allele_frequencies, mask.
    """

    entries: np.ndarray
    populations: np.ndarray
    loci_alleles: np.ndarray
    allele_frequencies: np.ndarray
    mask: Optional[np.ndarray] = None

    def __post_init__(self):
        self.entries = _as_str_array(self.entries)
        self.populations = _as_str_array(self.populations)
        self.loci_alleles = _as_str_array(self.loci_alleles)
        self.allele_frequencies = _as_float_matrix(self.allele_frequencies)
        if self.mask is None:
            self.mask = np.ones(self.allele_frequencies.shape, dtype=bool)
        else:
            self.mask = np.asarray(self.mask, dtype=bool)
        self._entry_index: Optional[Dict[str, int]] = None
        self._locus_index: Optional[Dict[str, int]] = None

    # -- dimensions -------------------------------------------------------
    @property
    def n(self) -> int:
        return self.allele_frequencies.shape[0]

    @property
    def p(self) -> int:
        return self.allele_frequencies.shape[1]

    def checkdims(self) -> bool:
        n, p = self.allele_frequencies.shape
        return (
            len(self.entries) == n
            and len(self.populations) == n
            and len(self.loci_alleles) == p
            and self.mask.shape == (n, p)
            and len(set(self.entries.tolist())) == n
            and len(set(self.loci_alleles.tolist())) == p
        )

    # -- indices ----------------------------------------------------------
    def entry_indices(self, names: Sequence[str]) -> np.ndarray:
        """Resolve entry names to integer row indices (built once, O(1) lookups)."""
        if self._entry_index is None or len(self._entry_index) != self.n:
            self._entry_index = {e: i for i, e in enumerate(self.entries.tolist())}
        try:
            return np.asarray([self._entry_index[x] for x in names], dtype=np.int64)
        except KeyError as err:
            raise KeyError(f"entry not found in genomes: {err}") from None

    def locus_indices(self, names: Sequence[str]) -> np.ndarray:
        if self._locus_index is None or len(self._locus_index) != self.p:
            self._locus_index = {e: i for i, e in enumerate(self.loci_alleles.tolist())}
        try:
            return np.asarray([self._locus_index[x] for x in names], dtype=np.int64)
        except KeyError as err:
            raise KeyError(f"locus-allele not found in genomes: {err}") from None

    # -- slicing ----------------------------------------------------------
    def slice(self, idx_entries=None, idx_loci_alleles=None) -> "Genomes":
        idx_e = np.arange(self.n) if idx_entries is None else np.asarray(idx_entries, dtype=np.int64)
        idx_l = np.arange(self.p) if idx_loci_alleles is None else np.asarray(idx_loci_alleles, dtype=np.int64)
        return Genomes(
            entries=self.entries[idx_e],
            populations=self.populations[idx_e],
            loci_alleles=self.loci_alleles[idx_l],
            allele_frequencies=self.allele_frequencies[np.ix_(idx_e, idx_l)],
            mask=self.mask[np.ix_(idx_e, idx_l)],
        )

    def __eq__(self, other) -> bool:
        if not isinstance(other, Genomes):
            return NotImplemented
        return (
            np.array_equal(self.entries, other.entries)
            and np.array_equal(self.populations, other.populations)
            and np.array_equal(self.loci_alleles, other.loci_alleles)
            and np.allclose(self.allele_frequencies, other.allele_frequencies, atol=1e-12, equal_nan=True)
        )


@dataclass
class Phenomes:
    """n entries x t traits phenotype matrix (NaN = missing) with metadata."""

    entries: np.ndarray
    populations: np.ndarray
    traits: np.ndarray
    phenotypes: np.ndarray
    mask: Optional[np.ndarray] = None

    def __post_init__(self):
        self.entries = _as_str_array(self.entries)
        self.populations = _as_str_array(self.populations)
        self.traits = _as_str_array(self.traits)
        self.phenotypes = _as_float_matrix(self.phenotypes)
        if self.mask is None:
            self.mask = np.ones(self.phenotypes.shape, dtype=bool)
        else:
            self.mask = np.asarray(self.mask, dtype=bool)

    @property
    def n(self) -> int:
        return self.phenotypes.shape[0]

    @property
    def t(self) -> int:
        return self.phenotypes.shape[1]

    def checkdims(self) -> bool:
        n, t = self.phenotypes.shape
        return (
            len(self.entries) == n
            and len(self.populations) == n
            and len(self.traits) == t
            and self.mask.shape == (n, t)
            and len(set(self.entries.tolist())) == n
            and len(set(self.traits.tolist())) == t
        )

    def trait_index(self, trait: str) -> int:
        hits = np.flatnonzero(self.traits == trait)
        if len(hits) == 0:
            raise KeyError(f"trait not found: {trait!r}")
        return int(hits[0])

    def slice(self, idx_entries=None, idx_traits=None) -> "Phenomes":
        idx_e = np.arange(self.n) if idx_entries is None else np.asarray(idx_entries, dtype=np.int64)
        idx_t = np.arange(self.t) if idx_traits is None else np.asarray(idx_traits, dtype=np.int64)
        return Phenomes(
            entries=self.entries[idx_e],
            populations=self.populations[idx_e],
            traits=self.traits[idx_t],
            phenotypes=self.phenotypes[np.ix_(idx_e, idx_t)],
            mask=self.mask[np.ix_(idx_e, idx_t)],
        )


@dataclass
class Trials:
    """Long-format phenotype records across years/seasons/sites/replications.

    Equivalent of GenomicBreedingCore's `Trials` as consumed by
    `extractphenomes` in the reference doctests.
    """

    entries: np.ndarray  # (m,) entry name per record
    populations: np.ndarray  # (m,)
    years: np.ndarray  # (m,)
    seasons: np.ndarray  # (m,)
    sites: np.ndarray  # (m,)
    replications: np.ndarray  # (m,)
    traits: np.ndarray  # (t,) trait names
    phenotypes: np.ndarray  # (m, t)

    def __post_init__(self):
        for f in ("entries", "populations", "years", "seasons", "sites", "replications", "traits"):
            setattr(self, f, _as_str_array(getattr(self, f)))
        self.phenotypes = _as_float_matrix(self.phenotypes)


@dataclass
class SimulatedEffects:
    """Ground-truth simulated genetic architecture (for tests and GWAS checks)."""

    trait: str
    idx_additive: np.ndarray  # QTL column indices
    additive_effects: np.ndarray
    idx_dominance: np.ndarray
    dominance_effects: np.ndarray
    idx_epistasis: np.ndarray  # (k, 2) pairs
    epistasis_effects: np.ndarray
    genetic_values: np.ndarray  # (n,) total genetic value per entry
    variance_components: Dict[str, float] = field(default_factory=dict)


@dataclass
class Fit:
    """Fitted-model container (reference Fit struct, src/linear.jl:77-98)."""

    model: str = ""
    b_hat: np.ndarray = field(default_factory=lambda: np.zeros(0))
    b_hat_labels: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=object))
    trait: str = ""
    entries: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=object))
    populations: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=object))
    y_true: np.ndarray = field(default_factory=lambda: np.zeros(0))
    y_pred: np.ndarray = field(default_factory=lambda: np.zeros(0))
    metrics: Dict[str, float] = field(default_factory=dict)
    extras: Dict[str, object] = field(default_factory=dict)

    def __post_init__(self):
        self.b_hat = np.asarray(self.b_hat, dtype=np.float64)
        self.b_hat_labels = _as_str_array(self.b_hat_labels)
        self.entries = _as_str_array(self.entries)
        self.populations = _as_str_array(self.populations)
        self.y_true = np.asarray(self.y_true, dtype=np.float64)
        self.y_pred = np.asarray(self.y_pred, dtype=np.float64)

    def checkdims(self) -> bool:
        return (
            len(self.b_hat) == len(self.b_hat_labels)
            and len(self.entries) == len(self.populations)
            and len(self.y_true) == len(self.y_pred)
        )


@dataclass
class CV:
    """One cross-validation job result (reference CV struct, src/cross_validation.jl:79)."""

    replication: str
    fold: str
    fit: Fit
    validation_populations: np.ndarray
    validation_entries: np.ndarray
    y_true: np.ndarray
    y_pred: np.ndarray
    metrics: Dict[str, float]

    def __post_init__(self):
        self.validation_populations = _as_str_array(self.validation_populations)
        self.validation_entries = _as_str_array(self.validation_entries)
        self.y_true = np.asarray(self.y_true, dtype=np.float64)
        self.y_pred = np.asarray(self.y_pred, dtype=np.float64)

    def checkdims(self) -> bool:
        m = len(self.validation_entries)
        return (
            len(self.validation_populations) == m
            and len(self.y_true) == m
            and len(self.y_pred) == m
            and self.fit.checkdims()
        )


# -- module-level helpers mirroring the reference's free functions -----------

def checkdims(obj) -> bool:
    return obj.checkdims()


def slice_genomes(genomes: Genomes, idx_entries=None, idx_loci_alleles=None) -> Genomes:
    return genomes.slice(idx_entries=idx_entries, idx_loci_alleles=idx_loci_alleles)


def slice_phenomes(phenomes: Phenomes, idx_entries=None, idx_traits=None) -> Phenomes:
    return phenomes.slice(idx_entries=idx_entries, idx_traits=idx_traits)


def clone(obj):
    return copy.deepcopy(obj)
