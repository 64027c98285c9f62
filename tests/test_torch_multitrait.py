"""The port's multi-trait and multi-environment GBLUP (models/multitrait.py,
models/gblup.py:gblup_multitrait) held against the JAX package on the CPU,
on tests/test_multitrait.py's fixtures made from the same seeds: two traits
sharing one genetic signal (h² 0.6 and 0.15), and a 3-year x 2-site trial."""

import numpy as np
import pytest
import torch

import genomicbreedingmodels_tpu as gj
import genomicbreedingmodels_tpu_torch as gt
from genomicbreedingmodels_tpu.models import multitrait as mt_j
from genomicbreedingmodels_tpu_torch import convert
from genomicbreedingmodels_tpu_torch.models import multitrait as mt_t

torch.set_num_threads(2)
CPU = "cpu"


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope="module")
def correlated_traits():
    genomes = gj.simulate_genomes(n=150, l=800, seed=21)
    trials, effects = gj.simulate_trials(genomes, f_add_dom_epi=np.array([[0.6, 0.0, 0.0]]), seed=21)
    g = effects[0].genetic_values
    rng = np.random.default_rng(77)
    y1 = np.sqrt(0.6) * g + np.sqrt(0.4) * rng.normal(size=len(g))
    y2 = np.sqrt(0.15) * g + np.sqrt(0.85) * rng.normal(size=len(g))
    phenomes = gj.Phenomes(
        entries=genomes.entries, populations=genomes.populations,
        traits=np.asarray(["trait_1", "trait_2"], dtype=object),
        phenotypes=np.stack([y1, y2], axis=1),
    )
    return genomes, phenomes, g


def _missing(phenomes, frac=0.3, seed=3):
    """A copy with `frac` of trait_2's records missing."""
    ph = gj.clone(phenomes)
    n = ph.phenotypes.shape[0]
    ph.phenotypes[np.random.default_rng(seed).choice(n, int(frac * n), replace=False), 1] = np.nan
    return ph


@pytest.fixture(scope="module")
def rotated(correlated_traits):
    """The fixture's GRM eigendecomposition (f64) and rotated centred traits."""
    genomes, phenomes, _ = correlated_traits
    K = np.asarray(gj.grm_simple(genomes).genomic_relationship_matrix, np.float64)
    s, U = np.linalg.eigh((K + K.T) / 2.0)
    Y = phenomes.phenotypes
    return np.maximum(s, 0.0), U, Y


def test_mtgblup_em_matches(rotated):
    """Same rotated inputs: G_g, R, M and the log-likelihood trace within 1e-8."""
    s, U, Y = rotated
    Yt = U.T @ (Y - Y.mean(axis=0))
    a = gj.mtgblup_em(Yt, s)
    b = gt.mtgblup_em(Yt, s, device=CPU)
    assert len(b[3]) == len(a[3])
    for x, y in zip(b, a):
        assert _rel(x, y) <= 1e-8


def test_mtgblup_em_missing_matches(rotated):
    """Same inputs with a quarter of trait_2 missing: G_g, R, M, mu and the
    log-likelihood trace within 1e-8."""
    s, U, Y = rotated
    Ym = Y.copy()
    Ym[::4, 1] = np.nan
    a = mt_j.mtgblup_em_missing(Ym, s, U)
    b = mt_t.mtgblup_em_missing(Ym, s, U, device=CPU)
    assert len(b[4]) == len(a[4])
    for x, y in zip(b, a):
        assert _rel(x, y) <= 1e-8


@pytest.mark.parametrize("policy", ["em", "complete-case"])
def test_gblup_multitrait_cov_matches(correlated_traits, policy):
    """30 % of trait_2 missing: G_g and R within 1e-3 relative, each trait's
    y_pred cor >= 0.9999, the same entries per trait, the four stages timed."""
    genomes, phenomes, _ = correlated_traits
    ph = _missing(phenomes)
    fj = gj.gblup_multitrait_cov(genomes, ph, missing_policy=policy)
    ft = gt.gblup_multitrait_cov(convert.genomes_from_reference(genomes),
                                 convert.phenomes_from_reference(ph),
                                 missing_policy=policy, device=CPU)
    assert [f.trait for f in ft] == [f.trait for f in fj] == ["trait_1", "trait_2"]
    for k in ("genetic_covariance", "residual_covariance"):
        assert _rel(ft[0].extras[k], fj[0].extras[k]) <= 1e-3, k
    for a, b in zip(ft, fj):
        assert np.array_equal(a.entries, b.entries) and a.checkdims()
        assert np.corrcoef(a.y_pred, b.y_pred)[0, 1] >= 0.9999
    assert set(ft[0].extras["stage_seconds"]) == {"grm", "eigh", "em", "effects"}


def test_gblup_multitrait_matches(correlated_traits):
    """One GRM and one eigendecomposition for the complete traits, gblup for
    the incomplete one; per trait y_pred cor >= 0.9999 and σ² within 1e-3
    relative; the fits in the order of phenomes.traits (the JAX package
    lists the complete traits first)."""
    genomes, phenomes, _ = correlated_traits
    Y = phenomes.phenotypes
    ph = gj.Phenomes(entries=phenomes.entries, populations=phenomes.populations,
                     traits=np.asarray(["a", "b", "c"], dtype=object),
                     phenotypes=np.stack([Y[:, 0], Y[:, 1], Y[:, 0] + Y[:, 1]], axis=1))
    ph.phenotypes[5, 1] = np.nan
    fj = {f.trait: f for f in gj.gblup_multitrait(genomes, ph)}
    ft = gt.gblup_multitrait(convert.genomes_from_reference(genomes),
                             convert.phenomes_from_reference(ph), device=CPU)
    assert [f.trait for f in ft] == ["a", "b", "c"]
    for f in ft:
        ref = fj[f.trait]
        assert f.checkdims() and np.array_equal(f.entries, ref.entries)
        assert np.corrcoef(f.y_pred, ref.y_pred)[0, 1] >= 0.9999
        for k in ("sigma2_e", "sigma2_u"):
            assert f.extras[k] == pytest.approx(ref.extras[k], rel=1e-3), (f.trait, k)


@pytest.fixture(scope="module")
def trial_set():
    genomes = gj.simulate_genomes(n=100, l=500, seed=5)
    pv = np.array([[0.5], [0.2], [0.0], [0.1], [0.0], [0.0], [0.0], [0.0]])
    trials, effects = gj.simulate_trials(
        genomes, n_years=3, n_sites=2, n_replications=2,
        f_add_dom_epi=np.array([[0.5, 0.0, 0.0]]), proportion_of_variance=pv, seed=5,
    )
    return genomes, trials


def test_gblup_multienv_matches(trial_set):
    """σ²ᵤ, σ²ₑ and σ²_env within 1e-3 relative, the same environments,
    y_pred cor >= 0.9999."""
    genomes, trials = trial_set
    fj = gj.gblup_multienv(genomes, trials)
    ft = gt.gblup_multienv(convert.genomes_from_reference(genomes),
                           convert.trials_from_reference(trials), device=CPU)
    for k in ("sigma2_u", "sigma2_e", "sigma2_env"):
        assert ft.extras[k] == pytest.approx(fj.extras[k], rel=1e-3), k
    assert ft.extras["n_environments"] == fj.extras["n_environments"] == 6
    assert set(ft.extras["env_effects"]) == set(fj.extras["env_effects"])
    assert np.corrcoef(ft.y_pred, fj.y_pred)[0, 1] >= 0.9999


def test_converted_multitrait_fits(correlated_traits, trial_set):
    """JAX multi-trait and multi-env Fits carried across: the t×t covariances
    as numpy arrays, the env effects as a dict, and each converted Fit
    predicts through the port's predict as through the JAX one."""
    genomes, phenomes, _ = correlated_traits
    fj = gj.gblup_multitrait_cov(genomes, phenomes, idx_entries=np.arange(120))[1]
    fit = convert.fit_from_reference(fj)
    for k in ("genetic_covariance", "residual_covariance", "genetic_correlations"):
        assert isinstance(fit.extras[k], np.ndarray) and fit.extras[k].shape == (2, 2)
        assert fit.extras[k] is not fj.extras[k] and np.array_equal(fit.extras[k], fj.extras[k])
    idx = np.arange(120, 150)
    pj = gj.predict(fj, genomes, idx)
    pt = gt.predict(fit, convert.genomes_from_reference(genomes), idx, device=CPU)
    assert np.abs(pt - pj).max() <= 1e-5 * max(1.0, np.abs(pj).max())
    g_env, trials = trial_set
    fe = gj.gblup_multienv(g_env, trials)
    fit_e = convert.fit_from_reference(fe)
    assert fit_e.extras["env_effects"] == fe.extras["env_effects"]
    assert fit_e.extras["env_effects"] is not fe.extras["env_effects"]
    tr = convert.trials_from_reference(trials)
    assert np.array_equal(tr.phenotypes, trials.phenotypes) and np.array_equal(tr.sites, trials.sites)


def test_multitrait_cov_errors(correlated_traits):
    genomes, phenomes, _ = correlated_traits
    g = convert.genomes_from_reference(genomes)
    ph = gj.clone(phenomes)
    ph.phenotypes[:149, 1] = np.nan  # < 2 complete rows
    p = convert.phenomes_from_reference(ph)
    with pytest.raises(ValueError, match="complete multi-trait"):
        gt.gblup_multitrait_cov(g, p, missing_policy="complete-case", device=CPU)
    with pytest.raises(ValueError, match="missing_policy"):
        gt.gblup_multitrait_cov(g, p, missing_policy="bogus", device=CPU)
