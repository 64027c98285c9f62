"""Port GBLUP pieces held against their JAX twins: the lower-triangle solve,
the REML scan, variance components, gblup + predict, and a JAX Fit carried
across by convert.fit_from_reference."""

import numpy as np
import pytest
import torch

import genomicbreedingmodels_tpu as gj
import genomicbreedingmodels_tpu_torch as gt
from genomicbreedingmodels_tpu.models.gwas import _reml_scan as reml_scan_jax
from genomicbreedingmodels_tpu.ops.chol import gblup_solve_lower as solve_jax
from genomicbreedingmodels_tpu.ops.grm import center_gram_lower as center_lower_jax
from genomicbreedingmodels_tpu_torch import convert
from genomicbreedingmodels_tpu_torch.models.gwas import _reml_scan, _rotated_loglik
from genomicbreedingmodels_tpu_torch.ops.chol import gblup_solve_lower
from genomicbreedingmodels_tpu_torch.ops.grm import center_gram_lower

torch.set_num_threads(2)
CPU = "cpu"
IDX_TRAIN = np.arange(90)
IDX_TEST = np.arange(90, 100)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _called(genomes):
    return type(genomes)(
        entries=genomes.entries, populations=genomes.populations,
        loci_alleles=genomes.loci_alleles,
        allele_frequencies=np.rint(2.0 * genomes.allele_frequencies) / 2.0,
    )


@pytest.mark.parametrize("lam", [0.1, 5.0])
def test_gblup_solve_lower_reads_lower_triangle_only(sim_small, lam):
    X = sim_small[0].allele_frequencies.astype(np.float32)
    L = np.tril(X @ X.T)
    K = center_gram_lower(torch.from_numpy(L))  # upper triangle holds garbage
    assert torch.triu(K, 1).abs().max() > 0
    y = np.random.default_rng(0).normal(size=X.shape[0]).astype(np.float32)
    gebv = gblup_solve_lower(K, torch.from_numpy(y), lam).numpy()
    gebv_j = np.asarray(solve_jax(center_lower_jax(L), y, np.float32(lam)))
    assert _rel(gebv, gebv_j) <= 1e-4
    Kl = torch.tril(K)
    mirrored = gblup_solve_lower(Kl + torch.tril(Kl, -1).T, torch.from_numpy(y), lam).numpy()
    assert _rel(gebv, mirrored) <= 1e-6
    # garbage swapped for other garbage: same answer
    noisy = Kl + torch.triu(torch.full_like(K, 1e3), 1)
    assert np.array_equal(gblup_solve_lower(noisy, torch.from_numpy(y), lam).numpy(), gebv)


def _reml_inputs(sim_small, n_markers):
    genomes, phenomes, _ = sim_small
    X = genomes.allele_frequencies
    K = np.asarray(gj.grm_simple(genomes).genomic_relationship_matrix, np.float64)
    s, U = np.linalg.eigh((K + K.T) / 2)
    s = np.maximum(s, 0) / np.mean(np.diag(K))
    y = phenomes.phenotypes[:, 0]
    ys = (y - y.mean()) / y.std(ddof=1)
    Xt = np.stack([U.T @ np.stack([np.ones(len(y)), X[:, j]], 1) for j in range(n_markers)])
    return (U.T @ ys).astype(np.float32), Xt.astype(np.float32), s.astype(np.float32)


def test_reml_scan_matches(sim_small):
    # Several markers in one call: every batch element of the vmapped scan must
    # agree, not only the first (forward-mode AD of slogdet/solve is
    # mis-batched under torch.func.vmap, hence jacrev(jacrev) in the port).
    yt, Xt, s = _reml_inputs(sim_small, n_markers=4)
    zj, thj = (np.asarray(a) for a in reml_scan_jax(yt, Xt, s))
    zt, tht = _reml_scan(torch.from_numpy(yt), torch.from_numpy(Xt), torch.from_numpy(s))
    assert tht.shape == (4, 2) and zt.shape == (4,)
    np.testing.assert_allclose(tht.numpy(), thj, rtol=1e-3)
    np.testing.assert_allclose(zt.numpy(), zj, rtol=1e-3, atol=1e-4)
    # the port's optimum is no worse than JAX's under the float64 objective
    y64, X64, s64 = (torch.tensor(a, dtype=torch.float64) for a in (yt, Xt, s))
    for j in range(4):
        ll_t = float(_rotated_loglik(tht[j].double(), y64, X64[j], s64))
        ll_j = float(_rotated_loglik(torch.tensor(thj[j], dtype=torch.float64), y64, X64[j], s64))
        assert ll_t <= ll_j + 1e-5 * abs(ll_j)


def test_reml_variance_components_matches(sim_small):
    genomes, phenomes, _ = sim_small
    y = phenomes.phenotypes[:, 0]
    K = np.asarray(gj.grm_simple(genomes).genomic_relationship_matrix, np.float64)
    ej = gj.reml_variance_components(y, K)
    et = gt.reml_variance_components(y, K, device=CPU)
    np.testing.assert_allclose(et, ej, rtol=1e-3)


def test_loglikreml_matches(sim_small):
    genomes, phenomes, _ = sim_small
    y = phenomes.phenotypes[:, 0]
    K = np.asarray(gj.grm_simple(genomes).genomic_relationship_matrix, np.float64)
    X1 = np.ones((len(y), 1))
    for theta in ([0.5, 0.5], [1e-3, 1.0], [1.0, 1e-3]):
        assert gt.loglikreml(theta, (y, X1, K)) == gj.loglikreml(theta, (y, X1, K))


@pytest.mark.parametrize(
    "called,grm_type", [(False, "simple"), (True, "simple"), (False, "ploidy-aware")]
)
def test_gblup_and_predict_match(sim_small, called, grm_type):
    genomes, phenomes, _ = sim_small
    if called:
        genomes = _called(genomes)
    fj = gj.gblup(genomes, phenomes, idx_entries=IDX_TRAIN, GRM_type=grm_type)
    g, p = convert.genomes_from_reference(genomes), convert.phenomes_from_reference(phenomes)
    ft = gt.gblup(g, p, idx_entries=IDX_TRAIN, GRM_type=grm_type, device=CPU)
    assert ft.model == "gblup" and ft.checkdims()
    assert np.array_equal(ft.b_hat_labels, fj.b_hat_labels)
    sd = fj.y_true.std()
    assert np.corrcoef(ft.y_pred, fj.y_pred)[0, 1] >= 0.9999
    assert np.abs(ft.y_pred - fj.y_pred).max() / sd <= 2e-4
    for k in ("sigma2_e", "sigma2_u", "h2"):
        assert ft.extras[k] == pytest.approx(fj.extras[k], rel=1e-3), k
    assert set(ft.extras["stage_seconds"]) == {"extract", "grm", "eigh", "reml", "effects"}
    assert ft.metrics["cor"] == pytest.approx(fj.metrics["cor"], abs=1e-4)
    pj = gj.predict(fj, genomes, IDX_TEST)
    pt = gt.predict(ft, g, IDX_TEST, device=CPU)
    assert np.corrcoef(pt, pj)[0, 1] >= 0.9999
    assert np.abs(pt - pj).max() / sd <= 2e-4


def test_converted_fit_predicts_like_jax(sim_small):
    genomes, phenomes, _ = sim_small
    fj = gj.gblup(genomes, phenomes, idx_entries=IDX_TRAIN)
    fit = convert.fit_from_reference(fj)
    assert fit.checkdims() and fit.extras["sigma2_u"] == fj.extras["sigma2_u"]
    pj = gj.predict(fj, genomes, IDX_TEST)
    pt = gt.predict(fit, convert.genomes_from_reference(genomes), IDX_TEST, device=CPU)
    assert np.abs(pt - pj).max() <= 1e-5 * max(1.0, np.abs(pj).max())


def test_predict_errors(sim_small):
    genomes, phenomes, _ = sim_small
    g = convert.genomes_from_reference(genomes)
    fit = convert.fit_from_reference(gj.gblup(genomes, phenomes, idx_entries=IDX_TRAIN))
    with pytest.raises(IndexError):
        gt.predict(fit, g, [0, 1000], device=CPU)
    fit.model = "mlp"  # a linear Fit relabelled: no network to predict with
    with pytest.raises(ValueError, match="'mlp' Fit carries no network"):
        gt.predict(fit, g, IDX_TEST, device=CPU)
    fit.model = "nonsense"
    with pytest.raises(ValueError, match="unrecognised"):
        gt.predict(fit, g, IDX_TEST, device=CPU)
    with pytest.raises(ValueError, match="GRM_type"):
        gt.gblup(g, convert.phenomes_from_reference(phenomes), GRM_type="x", device=CPU)
