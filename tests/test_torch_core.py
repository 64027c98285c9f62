"""Port data layer held against the JAX package: simulators (bit-identical),
extractxyetc, structs, metrics (1e-12) and metrics_vector."""

import numpy as np
import pytest
import torch

import genomicbreedingmodels_tpu as gj
import genomicbreedingmodels_tpu_torch as gt
from genomicbreedingmodels_tpu.ops.metrics import metrics_vector as metrics_vector_jax
from genomicbreedingmodels_tpu_torch import convert
from genomicbreedingmodels_tpu_torch.ops.metrics import metrics_vector

torch.set_num_threads(2)


def _same_genomes(a, b):
    assert np.array_equal(a.entries, b.entries)
    assert np.array_equal(a.populations, b.populations)
    assert np.array_equal(a.loci_alleles, b.loci_alleles)
    assert np.array_equal(a.allele_frequencies, b.allele_frequencies, equal_nan=True)
    assert np.array_equal(a.mask, b.mask)


@pytest.mark.parametrize(
    "kw",
    [
        dict(n=100, l=1000, seed=42),
        dict(n=120, l=500, n_populations=3, seed=7),
        dict(n=30, l=200, n_alleles=3, seed=3, sparsity=0.05),
    ],
)
def test_simulate_genomes_bit_identical(kw):
    _same_genomes(gj.simulate_genomes(**kw), gt.simulate_genomes(**kw))


def test_simulate_trials_and_extract_phenomes_bit_identical():
    gen_j = gj.simulate_genomes(n=60, l=300, n_populations=2, seed=11)
    gen_t = gt.simulate_genomes(n=60, l=300, n_populations=2, seed=11)
    f = np.array([[0.4, 0.05, 0.05], [0.3, 0.0, 0.1]])
    kw = dict(n_years=2, n_sites=2, n_replications=2, f_add_dom_epi=f, seed=11)
    tj, ej = gj.simulate_trials(gen_j, **kw)
    tt, et = gt.simulate_trials(gen_t, **kw)
    for field in ("entries", "populations", "years", "seasons", "sites", "replications", "traits"):
        assert np.array_equal(getattr(tj, field), getattr(tt, field))
    assert np.array_equal(tj.phenotypes, tt.phenotypes)
    for a, b in zip(ej, et):
        assert np.array_equal(a.idx_additive, b.idx_additive)
        assert np.array_equal(a.genetic_values, b.genetic_values)
        assert a.variance_components == b.variance_components
    pj, pt = gj.extract_phenomes(tj), gt.extract_phenomes(tt)
    assert np.array_equal(pj.entries, pt.entries)
    assert np.array_equal(pj.populations, pt.populations)
    assert np.array_equal(pj.phenotypes, pt.phenotypes, equal_nan=True)


@pytest.mark.parametrize("add_intercept", [True, False])
def test_extractxyetc_matches(sim_small, add_intercept):
    genomes, phenomes, _ = sim_small
    idx_e = np.arange(5, 95)
    idx_l = np.arange(0, 1000, 3)
    out_j = gj.extractxyetc(genomes, phenomes, idx_entries=idx_e, idx_loci_alleles=idx_l,
                            add_intercept=add_intercept)
    out_t = gt.extractxyetc(convert.genomes_from_reference(genomes),
                            convert.phenomes_from_reference(phenomes),
                            idx_entries=idx_e, idx_loci_alleles=idx_l,
                            add_intercept=add_intercept)
    for a, b in zip(out_j, out_t):
        assert np.array_equal(a, b)


def test_extractxyetc_impute_and_errors():
    g = gt.simulate_genomes(n=20, l=50, seed=1)
    t, _ = gt.simulate_trials(g, seed=1)
    p = gt.extract_phenomes(t)
    g.allele_frequencies[np.random.default_rng(1).random(g.allele_frequencies.shape) < 0.1] = np.nan
    with pytest.raises(ValueError, match="missing"):
        gt.extractxyetc(g, p)
    X, *_ = gt.extractxyetc(g, p, impute_missing="mean")
    Xj, *_ = gj.extractxyetc(g, p, impute_missing="mean")
    assert np.isfinite(X).all() and np.array_equal(X, Xj)
    with pytest.raises(IndexError):
        gt.extractxyetc(g, p, idx_entries=[0, 99])


def test_structs_slice_clone_checkdims(sim_small):
    genomes, phenomes, _ = sim_small
    g = convert.genomes_from_reference(genomes)
    p = convert.phenomes_from_reference(phenomes)
    assert gt.checkdims(g) and gt.checkdims(p)
    gs = gt.slice_genomes(g, idx_entries=[3, 1], idx_loci_alleles=[0, 5, 7])
    gsj = gj.slice_genomes(genomes, idx_entries=[3, 1], idx_loci_alleles=[0, 5, 7])
    _same_genomes(gs, gsj)
    ps = gt.slice_phenomes(p, idx_entries=[2, 4])
    assert np.array_equal(ps.phenotypes, p.phenotypes[[2, 4]])
    c = gt.clone(g)
    assert c == g and c is not g


def test_mean_impute_matches():
    rng = np.random.default_rng(0)
    G = rng.random((10, 6))
    G[rng.random((10, 6)) < 0.3] = np.nan
    G[:, 2] = np.nan
    assert np.array_equal(gt.mean_impute(G), gj.mean_impute(G))


_CASES = {
    "random": lambda r: (r.normal(size=50), r.normal(size=50)),
    "correlated": lambda r: (lambda a: (a, a + 0.1 * r.normal(size=40)))(r.normal(size=40)),
    "constant_pred": lambda r: (r.normal(size=20), np.full(20, 1.5)),
    "positive": lambda r: (r.random(30) + 1, r.random(30) + 1),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_metrics_matches(case):
    yt, yp = _CASES[case](np.random.default_rng(3))
    mj, mt = gj.metrics(yt, yp), gt.metrics(yt, yp)
    assert mj.keys() == mt.keys()
    for k in mj:
        assert abs(mj[k] - mt[k]) <= 1e-12 * max(1.0, abs(mj[k])), k


@pytest.mark.parametrize("case", sorted(_CASES))
def test_metrics_vector_matches(case):
    yt, yp = _CASES[case](np.random.default_rng(4))
    vj = np.asarray(metrics_vector_jax(yt.astype(np.float32), yp.astype(np.float32)))
    vt = metrics_vector(yt, yp, device="cpu").numpy()
    assert vt.dtype == np.float32
    np.testing.assert_allclose(vt, vj, rtol=1e-5, atol=1e-6)


def test_metrics_vector_cuda_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        metrics_vector(np.ones(3), np.ones(3))
