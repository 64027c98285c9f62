"""The port's batched CV engine (cv/batched.py: cvbulk_batched for ridge,
gblup and lasso) held against the JAX package's on the sim_small fixture:
the same folds, tags and notes, the same chosen grid point per fold, and
y_pred within the stated tolerances; fits that predict through `predict`;
the Gram by K2's plain version; `mesh=`, not ported yet, raises."""

import numpy as np
import pytest
import torch

import genomicbreedingmodels_tpu as gj
import genomicbreedingmodels_tpu_torch as gt
from genomicbreedingmodels_tpu.cv import batched as batched_jax
from genomicbreedingmodels_tpu_torch import convert
from genomicbreedingmodels_tpu_torch.cv import batched

torch.set_num_threads(2)
CPU = "cpu"


@pytest.fixture(scope="module")
def runs(sim_small):
    """Both packages' cvbulk_batched on ridge, gblup and lasso, 2 × 3 folds,
    with a few missing phenotypes (skipped rows, not folds)."""
    genomes, phenomes, _ = sim_small
    ph = gj.clone(phenomes)
    ph.phenotypes[[3, 17, 40], 0] = np.nan
    kw = dict(models=("ridge", "gblup", "lasso"), n_replications=2, n_folds=3, seed=11)
    cj, nj = gj.cvbulk_batched(genomes, ph, **kw)
    g, p = convert.genomes_from_reference(genomes), convert.phenomes_from_reference(ph)
    ct, nt = gt.cvbulk_batched(g, p, device=CPU, **kw)
    return cj, nj, ct, nt, g, ph


def _keys(cvs):
    return [(cv.fit.trait, cv.fit.model, cv.replication, cv.fold) for cv in cvs]


def test_batched_tags_folds_and_notes_identical(runs):
    cj, nj, ct, nt, _, _ = runs
    assert _keys(ct) == _keys(cj) and nt == nj and len(ct) == 18
    for a, b in zip(ct, cj):
        assert a.checkdims()
        assert np.array_equal(a.validation_entries, b.validation_entries)
        assert np.array_equal(a.fit.entries, b.fit.entries)
        assert np.array_equal(a.y_true, b.y_true)
        assert a.fit.extras["engine"] == b.fit.extras["engine"]


@pytest.mark.parametrize("model", ["ridge", "gblup"])
def test_batched_dual_models_match_jax(runs, model):
    """The same grid point per fold (λ for ridge, the REML variance ratio for
    gblup), y_pred within 1e-4·std(y) on the validation and the training
    rows, the marker effects within 1e-4 relative norm. The intercept is
    finite in the port; the JAX package's is NaN once a phenotype is missing
    (it sums w·φ with 0·NaN = NaN), so it is held to the port's own
    predictions in test_batched_fits_predict_through_generic_path."""
    cj, _, ct, _, _, ph = runs
    sd = np.nanstd(ph.phenotypes[:, 0])
    pairs = [(a, b) for a, b in zip(ct, cj) if a.fit.model == model]
    assert len(pairs) == 6
    for a, b in pairs:
        assert a.fit.extras["lambda"] == pytest.approx(b.fit.extras["lambda"], rel=1e-6)
        assert np.abs(a.y_pred - b.y_pred).max() <= 1e-4 * sd
        assert np.abs(a.fit.y_pred - b.fit.y_pred).max() <= 1e-4 * sd
        assert np.linalg.norm(a.fit.b_hat[1:] - b.fit.b_hat[1:]) <= 1e-4 * np.linalg.norm(b.fit.b_hat[1:])
        assert np.isfinite(a.fit.b_hat[0])


def test_batched_lasso_matches_jax(runs):
    """lasso: validation y_pred correlates ≥ 0.999 with the JAX package's in
    every fold."""
    cj, _, ct, _, _, _ = runs
    pairs = [(a, b) for a, b in zip(ct, cj) if a.fit.model == "lasso"]
    assert len(pairs) == 6
    for a, b in pairs:
        assert np.corrcoef(a.y_pred, b.y_pred)[0, 1] >= 0.999


def test_batched_fits_predict_through_generic_path(runs):
    """With store_effects, every fold's Fit predicts its validation rows
    through `predict` as the engine did (within 1e-4·std(y))."""
    _, _, ct, _, g, ph = runs
    sd = np.nanstd(ph.phenotypes[:, 0])
    for cv in ct:
        rows = g.entry_indices(cv.validation_entries.tolist())
        pred = gt.predict(cv.fit, g, rows, device=CPU)
        assert np.abs(pred - cv.y_pred).max() <= 1e-4 * sd, cv.fit.model


def test_batched_without_effects_and_same_folds_as_cvbulk(sim_small):
    """store_effects=False keeps only the intercept slot; the folds are
    cvbulk's for the same seed (one RNG stream)."""
    genomes, phenomes, _ = sim_small
    g, p = convert.genomes_from_reference(genomes), convert.phenomes_from_reference(phenomes)
    cb, _ = gt.cvbulk_batched(g, p, models=("ridge",), n_replications=1, n_folds=3, seed=2,
                              store_effects=False, device=CPU)
    cs, _ = gt.cvbulk(g, p, models=("ols",), n_replications=1, n_folds=3, seed=2, device=CPU)
    assert all(cv.fit.b_hat.shape == (1,) for cv in cb)
    assert [cv.validation_entries.tolist() for cv in cb] == [cv.validation_entries.tolist() for cv in cs]
    assert batched.LAST_TIMER is not None and "ridge_solve" in batched.LAST_TIMER.totals


def test_gram_matches_jax(sim_small):
    """The centered Gram (K2's plain version on a CPU tensor, mirrored)
    against the JAX XLA product: within 1e-5·max|K|; Z identical to f32."""
    X = sim_small[0].allele_frequencies.astype(np.float32)
    Kj, Zj = (np.asarray(a) for a in batched_jax._gram(X))
    Kt, Zt = batched._gram(torch.from_numpy(X))
    assert torch.equal(Kt, Kt.T)
    assert np.abs(Kt.numpy() - Kj).max() <= 1e-5 * np.abs(Kj).max()
    np.testing.assert_allclose(Zt.numpy(), Zj, atol=1e-6)


def test_panel_cache_keys_on_device(sim_small):
    """The cached device panel is keyed on the host panel AND the device, so
    a call for another device never reuses this one's tensors."""
    genomes, phenomes, _ = sim_small
    g, p = convert.genomes_from_reference(genomes), convert.phenomes_from_reference(phenomes)
    gt.clear_device_caches()
    gt.cvbulk_batched(g, p, models=("ridge",), n_replications=1, n_folds=2, device=CPU)
    key, value = batched._PANEL_CACHE._slot
    assert key[-1] == "cpu" and value[0].device.type == "cpu"
    assert batched._PANEL_CACHE.get(key[:-1] + ("cuda",)) is None


def test_batched_argument_validation(sim_small):
    genomes, phenomes, _ = sim_small
    g, p = convert.genomes_from_reference(genomes), convert.phenomes_from_reference(phenomes)
    with pytest.raises(ValueError, match="n_folds"):
        gt.cvbulk_batched(g, p, n_folds=0, device=CPU)
    with pytest.raises(ValueError, match="n_replications"):
        gt.cvbulk_batched(g, p, n_replications=0, device=CPU)
    with pytest.raises(ValueError, match="not a batched CV model"):
        gt.cvbulk_batched(g, p, models=("mlp",), device=CPU)
    # A mesh of one rank gives mesh=None's CVs, bit for bit.
    from genomicbreedingmodels_tpu_torch.parallel.mesh import run_ranks

    kw = dict(models=("ridge", "bayesc"), n_replications=1, n_folds=2, mcmc_n_iter=8,
              mcmc_n_burnin=2)
    (one,) = run_ranks(lambda m: gt.cvbulk_batched(g, p, mesh=m, **kw), shape=(1, 1), device=CPU)
    ref = gt.cvbulk_batched(g, p, device=CPU, **kw)
    assert len(one[0]) == len(ref[0]) == 4
    for a, b in zip(one[0], ref[0]):
        assert a.fit.model == b.fit.model and np.array_equal(a.y_pred, b.y_pred)
