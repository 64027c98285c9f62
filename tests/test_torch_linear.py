"""The port's linear zoo (models/linear.py: ols, ridge, lasso) held against
the JAX package's on the sim_small fixture (train 90, test 10), through
`predict` too, and a JAX-fitted Fit predicting through the port."""

import numpy as np
import pytest
import torch

import genomicbreedingmodels_tpu as gj
import genomicbreedingmodels_tpu_torch as gt
from genomicbreedingmodels_tpu_torch import convert

torch.set_num_threads(2)
CPU = "cpu"
IDX_TRAIN = np.arange(90)
IDX_TEST = np.arange(90, 100)
# Few λ and folds keep both packages' paths short.
RIDGE_KW = dict(n_lambda=10, n_folds=3)
LASSO_KW = dict(n_lambda=8, n_folds=3, n_iter=200)


@pytest.fixture(scope="module")
def data(sim_small):
    genomes, phenomes, _ = sim_small
    return genomes, phenomes, convert.genomes_from_reference(genomes), convert.phenomes_from_reference(phenomes)


def _pair(data, name, **kw):
    gen_j, ph_j, gen_t, ph_t = data
    fj = getattr(gj, name)(gen_j, ph_j, idx_entries=IDX_TRAIN, **kw)
    ft = getattr(gt, name)(gen_t, ph_t, idx_entries=IDX_TRAIN, device=CPU, **kw)
    return fj, ft, gj.predict(fj, gen_j, IDX_TEST), gt.predict(ft, gen_t, IDX_TEST, device=CPU)


def _common(fj, ft):
    assert ft.checkdims() and ft.model == fj.model and ft.trait == fj.trait
    assert np.array_equal(ft.b_hat_labels, fj.b_hat_labels)
    assert np.array_equal(ft.entries, fj.entries) and np.array_equal(ft.y_true, fj.y_true)
    assert set(ft.metrics) == set(fj.metrics)


def test_ols_matches_jax(data):
    """Wide panel (p = 1000 > 90): the min-norm interpolant. Tolerance:
    fitted and predicted values within 1e-2·std(y) (the float32 dual solve
    interpolates to ~5e-3 in both packages, test_torch_linalg.py)."""
    fj, ft, pj, pt = _pair(data, "ols")
    _common(fj, ft)
    sd = fj.y_true.std()
    assert np.abs(ft.y_pred - fj.y_pred).max() <= 1e-2 * sd
    assert np.abs(pt - pj).max() <= 1e-2 * sd


def test_ridge_matches_jax(data):
    """The same chosen λ, b̂ within relative norm 1e-3, predictions within
    1e-4·std(y)."""
    fj, ft, pj, pt = _pair(data, "ridge", **RIDGE_KW)
    _common(fj, ft)
    assert ft.extras["lambda"] == pytest.approx(fj.extras["lambda"], rel=1e-5)
    assert np.linalg.norm(ft.b_hat - fj.b_hat) <= 1e-3 * np.linalg.norm(fj.b_hat)
    sd = fj.y_true.std()
    assert np.abs(pt - pj).max() <= 1e-4 * sd
    assert ft.metrics["cor"] == pytest.approx(fj.metrics["cor"], abs=1e-4)


def test_lasso_matches_jax(data):
    """The same chosen λ; fitted and predicted values correlate ≥ 0.999."""
    fj, ft, pj, pt = _pair(data, "lasso", **LASSO_KW)
    _common(fj, ft)
    assert ft.extras["lambda"] == pytest.approx(fj.extras["lambda"], rel=1e-5)
    assert np.corrcoef(ft.y_pred, fj.y_pred)[0, 1] >= 0.999
    assert np.corrcoef(pt, pj)[0, 1] >= 0.999


@pytest.mark.parametrize("name,kw", [("ridge", RIDGE_KW), ("lasso", LASSO_KW), ("ols", {})])
def test_converted_jax_fit_predicts_through_port(data, name, kw):
    """A JAX-fitted linear Fit carried across: the port's GEMV within
    1e-5·max(1, max|ŷ|) of the JAX one."""
    gen_j, ph_j, gen_t, _ = data
    fj = getattr(gj, name)(gen_j, ph_j, idx_entries=IDX_TRAIN, **kw)
    pt = gt.predict(convert.fit_from_reference(fj), gen_t, IDX_TEST, device=CPU)
    pj = gj.predict(fj, gen_j, IDX_TEST)
    assert np.abs(pt - pj).max() <= 1e-5 * max(1.0, np.abs(pj).max())


def test_linear_models_validate_and_take_device(data):
    _, _, gen_t, ph_t = data
    with pytest.raises(IndexError):
        gt.ridge(gen_t, ph_t, idx_entries=[0, 1000], device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cuda'"):
            gt.ols(gen_t, ph_t, idx_entries=IDX_TRAIN)
