"""Trial/genome simulators — the universal test fixture.

Re-implements the *semantics* of GenomicBreedingCore's `simulategenomes`,
`simulatetrials`, and `extractphenomes` as exercised by the reference doctests
(e.g. reference src/linear.jl:39-44, src/gwas.jl:41-52): multi-population
allele-frequency panels, additive/dominance/epistasis genetic architectures
with controllable variance fractions (`f_add_dom_epi`,
`proportion_of_variance`), and multi-environment trials that collapse to a
Phenomes via per-entry averaging.

This is a from-scratch design (the reference's core package is external and
not vendored); only the knobs and their doctest-level contracts are mirrored.

Copied verbatim from genomicbreedingmodels_tpu/core/simulation.py: it draws
from numpy's RNG only, so the same seed gives bit-identical panels and trials
in both packages.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .structs import Genomes, Phenomes, SimulatedEffects, Trials

__all__ = ["simulate_genomes", "simulate_trials", "extract_phenomes"]

_ALLELES = ["A", "T", "C", "G", "D"]  # D = deletion, mirroring biallelic+ panels


def simulate_genomes(
    n: int = 100,
    l: int = 10_000,
    n_alleles: int = 2,
    n_populations: int = 1,
    n_chroms: int = 7,
    seed: int = 42,
    sparsity: float = 0.0,
    n_founders: int = 8,
) -> Genomes:
    """Simulate an (n x p) allele-frequency panel, p = l * (n_alleles - 1).

    Population + family structure (the properties genomic prediction relies
    on, mirroring what the reference's external simulator provides for its
    doctests): per-locus ancestral allele distribution ~ Dirichlet; each
    population drifts around it; each population carries `n_founders` founder
    frequency profiles, and every entry is a sparse Dirichlet **mixture of
    founders** plus individual sampling noise. Shared founder ancestry gives
    entries non-trivial kinship (so GRM/GBLUP have signal to exploit) and
    induces LD between loci; per-locus allele frequencies respect the simplex
    (columns of one locus sum to <= 1).
    """
    if n < 2 or l < 1 or n_alleles < 2:
        raise ValueError("need n >= 2, l >= 1, n_alleles >= 2")
    if n_founders < 2:
        raise ValueError("need n_founders >= 2")
    rng = np.random.default_rng(seed)
    p = l * (n_alleles - 1)

    # Locus metadata: chromosome, position, allele names.
    chrom_of_locus = np.sort(rng.integers(1, n_chroms + 1, size=l))
    pos_of_locus = np.zeros(l, dtype=np.int64)
    for c in range(1, n_chroms + 1):
        idx = np.flatnonzero(chrom_of_locus == c)
        pos_of_locus[idx] = np.sort(rng.choice(135_000_000, size=len(idx), replace=False))
    allele_names = _ALLELES[:n_alleles]
    alleles_tag = "|".join(allele_names)
    loci_alleles = np.empty(p, dtype=object)
    k = 0
    for j in range(l):
        for a in range(n_alleles - 1):
            loci_alleles[k] = f"chrom_{chrom_of_locus[j]}\t{pos_of_locus[j]}\t{alleles_tag}\t{allele_names[a]}"
            k += 1

    # Entries and populations (contiguous blocks).
    entries = np.asarray([f"entry_{i + 1:05d}" for i in range(n)], dtype=object)
    pop_sizes = np.full(n_populations, n // n_populations)
    pop_sizes[: n % n_populations] += 1
    populations = np.concatenate(
        [np.full(sz, f"pop_{i + 1}", dtype=object) for i, sz in enumerate(pop_sizes)]
    )

    # Allele frequencies: ancestral Dirichlet -> population drift -> founder
    # profiles -> entries as founder mixtures (+ light individual noise).
    def _dirichlet_rows(conc: np.ndarray, size: Optional[tuple] = None) -> np.ndarray:
        """Sample Dirichlet variates along the last axis via normalized gammas.

        `size` broadcasts the concentration to that shape first (np.random's
        gamma draws exactly conc.shape variates otherwise — a silent collapse
        when the leading axis is 1).
        """
        conc = np.maximum(conc, 1e-3)
        if size is not None:
            conc = np.broadcast_to(conc, size)
        g = rng.gamma(conc)
        return g / np.maximum(g.sum(axis=-1, keepdims=True), 1e-30)

    ancestral = _dirichlet_rows(np.full((l, n_alleles), 2.0))  # (l, a)
    nu_pop = 30.0  # population drift concentration (tighter = less drift)
    nu_founder = 6.0  # founder spread around the population profile
    nu_entry = 50.0  # individual sampling noise around the founder mixture
    freqs = np.empty((n, p), dtype=np.float64)
    row = 0
    for i, sz in enumerate(pop_sizes):
        if n_populations > 1:
            pop_profile = _dirichlet_rows(ancestral * nu_pop)
        else:
            pop_profile = ancestral
        founders = _dirichlet_rows(
            pop_profile[None, :, :] * nu_founder, size=(n_founders, l, n_alleles)
        )  # (k, l, a)
        # Two-parent crosses: each entry mixes a dam and a sire founder, so
        # entries sharing a parent form half-/full-sib families.
        dam = rng.integers(0, n_founders, size=sz)
        sire = (dam + 1 + rng.integers(0, n_founders - 1, size=sz)) % n_founders
        u = rng.beta(3.0, 3.0, size=sz)
        weights = np.zeros((sz, n_founders))
        np.add.at(weights, (np.arange(sz), dam), u)
        np.add.at(weights, (np.arange(sz), sire), 1.0 - u)
        latent = np.einsum("ik,kla->ila", weights, founders)  # (sz, l, a)
        entry_freq = _dirichlet_rows(latent * nu_entry)
        freqs[row : row + sz] = entry_freq[:, :, : n_alleles - 1].reshape(sz, p)
        row += sz
    if sparsity > 0:
        miss = rng.random((n, p)) < sparsity
        freqs[miss] = np.nan

    return Genomes(
        entries=entries,
        populations=populations,
        loci_alleles=loci_alleles,
        allele_frequencies=freqs,
    )


def _standardise(x: np.ndarray) -> np.ndarray:
    s = np.std(x)
    if s < 1e-12:
        return np.zeros_like(x)
    return (x - np.mean(x)) / s


def simulate_trials(
    genomes: Genomes,
    n_years: int = 1,
    n_seasons: int = 1,
    n_harvests: int = 1,
    n_sites: int = 1,
    n_replications: int = 1,
    f_add_dom_epi: Optional[np.ndarray] = None,
    proportion_of_variance: Optional[np.ndarray] = None,
    n_qtl: int = 100,
    seed: int = 42,
) -> Tuple[Trials, list]:
    """Simulate multi-environment trials on top of a genome panel.

    - `f_add_dom_epi`: (t, 3) additive/dominance/epistasis phenotypic-variance
      fractions per trait (reference doctests pass e.g. [0.1 0.01 0.01]).
    - `proportion_of_variance`: optional (9, t); row 0 overrides the *total*
      genetic fraction per trait (split across a/d/e proportionally to
      `f_add_dom_epi`), rows 1..7 set year/season/site/replication/interaction
      variance fractions, the remainder is iid residual.

    Returns (Trials, [SimulatedEffects per trait]).
    """
    rng = np.random.default_rng(seed)
    if f_add_dom_epi is None:
        f_add_dom_epi = np.array([[0.1, 0.01, 0.01]])
    f_add_dom_epi = np.atleast_2d(np.asarray(f_add_dom_epi, dtype=np.float64))
    t = f_add_dom_epi.shape[0]
    X = genomes.allele_frequencies
    n, p = X.shape
    n_qtl = int(min(n_qtl, p))

    env_fracs = np.zeros((7, t))
    if proportion_of_variance is not None:
        pv = np.asarray(proportion_of_variance, dtype=np.float64)
        if pv.shape[1] != t:
            raise ValueError("proportion_of_variance must have one column per trait")
        genetic_frac = pv[0, :]
        env_fracs = pv[1:8, :]
    else:
        genetic_frac = f_add_dom_epi.sum(axis=1)
    if np.any(genetic_frac + env_fracs.sum(axis=0) > 1.0 + 1e-9):
        raise ValueError("variance fractions exceed 1")

    traits = np.asarray([f"trait_{k + 1}" for k in range(t)], dtype=object)
    het = 1.0 - np.abs(2.0 * X - 1.0)  # heterozygosity proxy in [0, 1]

    effects_out = []
    genetic_values = np.zeros((n, t))
    for k in range(t):
        fa, fd, fe = f_add_dom_epi[k]
        tot = fa + fd + fe
        if tot <= 0:
            weights = np.zeros(3)
        else:
            weights = np.array([fa, fd, fe]) / tot * genetic_frac[k]

        idx_add = rng.choice(p, size=n_qtl, replace=False)
        a_eff = rng.normal(0.0, 1.0, size=n_qtl)
        g_add = _standardise(X[:, idx_add] @ a_eff)

        n_dom = max(1, n_qtl // 5)
        idx_dom = rng.choice(p, size=n_dom, replace=False)
        d_eff = rng.normal(0.0, 1.0, size=n_dom)
        g_dom = _standardise(het[:, idx_dom] @ d_eff)

        n_epi = max(1, n_qtl // 5)
        idx_epi = rng.choice(p, size=(n_epi, 2), replace=False)
        e_eff = rng.normal(0.0, 1.0, size=n_epi)
        g_epi = _standardise((X[:, idx_epi[:, 0]] * X[:, idx_epi[:, 1]]) @ e_eff)

        g = np.sqrt(weights[0]) * g_add + np.sqrt(weights[1]) * g_dom + np.sqrt(weights[2]) * g_epi
        genetic_values[:, k] = g
        effects_out.append(
            SimulatedEffects(
                trait=str(traits[k]),
                idx_additive=idx_add,
                additive_effects=a_eff,
                idx_dominance=idx_dom,
                dominance_effects=d_eff,
                idx_epistasis=idx_epi,
                epistasis_effects=e_eff,
                genetic_values=g,
                variance_components={
                    "additive": float(weights[0]),
                    "dominance": float(weights[1]),
                    "epistasis": float(weights[2]),
                    "genetic": float(genetic_frac[k]),
                },
            )
        )

    # Environmental structure.
    years = [f"year_{i + 1}" for i in range(n_years)]
    seasons = [f"season_{i + 1}" for i in range(n_seasons)]
    sites = [f"site_{i + 1}" for i in range(n_sites)]
    reps = [f"replication_{i + 1}" for i in range(n_replications)]

    rec_entries, rec_pops, rec_years, rec_seasons, rec_sites, rec_reps = [], [], [], [], [], []
    rows = []
    env_names = ["years", "seasons", "sites", "replications", "year_x_season", "season_x_site", "site_x_rep"]
    env_effects = {
        "years": {y: rng.normal(size=t) for y in years},
        "seasons": {s: rng.normal(size=t) for s in seasons},
        "sites": {s: rng.normal(size=t) for s in sites},
        "replications": {r: rng.normal(size=t) for r in reps},
        "year_x_season": {(y, s): rng.normal(size=t) for y in years for s in seasons},
        "season_x_site": {(s, w): rng.normal(size=t) for s in seasons for w in sites},
        "site_x_rep": {(w, r): rng.normal(size=t) for w in sites for r in reps},
    }
    resid_frac = np.clip(1.0 - genetic_frac - env_fracs.sum(axis=0), 0.0, 1.0)

    for y in years:
        for s in seasons:
            for w in sites:
                for r in reps:
                    env = (
                        np.sqrt(env_fracs[0]) * env_effects["years"][y]
                        + np.sqrt(env_fracs[1]) * env_effects["seasons"][s]
                        + np.sqrt(env_fracs[2]) * env_effects["sites"][w]
                        + np.sqrt(env_fracs[3]) * env_effects["replications"][r]
                        + np.sqrt(env_fracs[4]) * env_effects["year_x_season"][(y, s)]
                        + np.sqrt(env_fracs[5]) * env_effects["season_x_site"][(s, w)]
                        + np.sqrt(env_fracs[6]) * env_effects["site_x_rep"][(w, r)]
                    )
                    noise = rng.normal(0.0, 1.0, size=(n, t)) * np.sqrt(resid_frac)
                    pheno = genetic_values + env[None, :] + noise
                    rows.append(pheno)
                    rec_entries.append(genomes.entries)
                    rec_pops.append(genomes.populations)
                    m = n
                    rec_years.append(np.full(m, y, dtype=object))
                    rec_seasons.append(np.full(m, s, dtype=object))
                    rec_sites.append(np.full(m, w, dtype=object))
                    rec_reps.append(np.full(m, r, dtype=object))

    trials = Trials(
        entries=np.concatenate(rec_entries),
        populations=np.concatenate(rec_pops),
        years=np.concatenate(rec_years),
        seasons=np.concatenate(rec_seasons),
        sites=np.concatenate(rec_sites),
        replications=np.concatenate(rec_reps),
        traits=traits,
        phenotypes=np.concatenate(rows, axis=0),
    )
    return trials, effects_out


def extract_phenomes(trials: Trials) -> Phenomes:
    """Collapse trial records to one phenotype per entry (NaN-aware mean)."""
    uniq_entries, first_idx = np.unique(trials.entries, return_index=True)
    order = np.argsort(first_idx)
    uniq_entries = uniq_entries[order]
    ent_to_row = {e: i for i, e in enumerate(uniq_entries.tolist())}
    n, t = len(uniq_entries), len(trials.traits)
    sums = np.zeros((n, t))
    counts = np.zeros((n, t))
    rows = np.asarray([ent_to_row[e] for e in trials.entries.tolist()])
    ok = np.isfinite(trials.phenotypes)
    np.add.at(sums, rows, np.where(ok, trials.phenotypes, 0.0))
    np.add.at(counts, rows, ok.astype(np.float64))
    with np.errstate(invalid="ignore", divide="ignore"):
        pheno = sums / counts
    pheno[counts == 0] = np.nan
    populations = np.empty(n, dtype=object)
    for e, pop in zip(trials.entries.tolist(), trials.populations.tolist()):
        populations[ent_to_row[e]] = pop
    return Phenomes(
        entries=uniq_entries,
        populations=populations,
        traits=trials.traits.copy(),
        phenotypes=pheno,
    )
