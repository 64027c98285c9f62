"""The port's marker-sharded Gibbs chain and its fold and pair-row mesh paths
on thread ranks over gloo on the CPU: the JAX test's limits
(tests/test_sharded_gibbs.py) against the port's and the JAX package's
single chains, bit-identity at D = 1 and across a crash-resume, and
`gibbs_cv_folds` / `cvbulk_batched` / `transform2` with a mesh against
mesh=None."""

import numpy as np
import pytest
import torch

import genomicbreedingmodels_tpu as gj
import genomicbreedingmodels_tpu_torch as gt
from genomicbreedingmodels_tpu_torch import convert
from genomicbreedingmodels_tpu_torch.parallel.mesh import run_ranks
from genomicbreedingmodels_tpu_torch.parallel.sharded import sharded_gibbs_regression
from genomicbreedingmodels_tpu_torch.utils.checkpoint import load_state

CPU = "cpu"
CHAIN = dict(n_iter=400, n_burnin=150, seed=1)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # the small chains run far faster on one thread
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    n, p = 130, 320
    X = rng.random((n, p)).astype(np.float32)
    b_true = np.zeros(p)
    b_true[[5, 120, 300]] = [1.5, -1.0, 1.2]
    y = X @ b_true + 0.3 * rng.normal(size=n)
    return X, y


def _sharded(X, y, D, **kw):
    """(mu, b) of the chain over D ranks, checked equal on every rank."""
    outs = run_ranks(lambda m: sharded_gibbs_regression(X, y, m, axis="mp", **kw), shape=(1, D),
                     device=CPU)
    for mu, b in outs[1:]:
        assert mu == outs[0][0] and np.array_equal(b, outs[0][1])
    return outs[0]


def _cor(a, b):
    return np.corrcoef(a, b)[0, 1]


TRAIN, HELD_OUT = np.arange(100), np.arange(100, 130)


@pytest.fixture(scope="module")
def chains(problem):
    """Per model, the chain over 2 ranks and the port's single chain on the
    training rows ((mu, b) each), and the JAX package's BayesC chain."""
    X, y = problem
    Xt, yt = X[TRAIN], y[TRAIN]
    out = {m: (_sharded(Xt, yt, 2, model=m, **CHAIN),
               gt.gibbs_regression(Xt, yt, model=m, device=CPU, **CHAIN)[:2])
           for m in ("BayesA", "BayesC", "BL")}
    out["jax"] = gj.gibbs_regression(Xt, yt, model="BayesC", **CHAIN)[:2]
    return out


def _heldout_cor(X, y, fit):
    mu, b = fit
    return _cor(mu + X[HELD_OUT] @ b, y[HELD_OUT])


@pytest.mark.parametrize("model", ["BayesA", "BayesC", "BL"])
def test_sharded_matches_single_chip_heldout(problem, chains, model):
    X, y = problem
    sharded, single = chains[model]
    assert sharded[1].shape == (320,)
    c2, c1 = _heldout_cor(X, y, sharded), _heldout_cor(X, y, single)
    assert c2 > 0.8 * c1 - 0.05, (model, c2, c1)
    if model == "BayesC":  # and against the JAX package's single chain
        assert c2 > 0.8 * _heldout_cor(X, y, chains["jax"]) - 0.05


def test_sharded_effects_track_single_chains(problem, chains):
    X, y = problem
    (_, b2), (_, b1) = chains["BayesC"]
    assert _cor(b2, b1) > 0.9 and _cor(b2, chains["jax"][1]) > 0.9
    # The concurrent (block-Jacobi) schedule on this weak-LD panel too.
    _, b_c = _sharded(X[TRAIN], y[TRAIN], 2, model="BayesC", device_schedule="concurrent",
                      n_iter=200, n_burnin=50, seed=1)
    assert _cor(b_c, b1) > 0.9


@pytest.mark.parametrize("model", ["BayesC", "BRR"])
def test_one_rank_is_gibbs_regression_bit_for_bit(problem, model):
    X, y = problem
    kw = dict(model=model, n_iter=60, n_burnin=20, seed=7, block_size=64)
    mu, b = _sharded(X, y, 1, **kw)
    mu1, b1, _ = gt.gibbs_regression(X, y, device=CPU, **kw)
    assert mu == mu1 and np.array_equal(b, b1)


def test_sharded_checkpoint_crash_resume(problem, tmp_path):
    """A chain killed mid-run resumes from its last segment and gives the
    uninterrupted chain's bits; a complete snapshot gives its means."""
    X, y = problem
    kw = dict(model="BayesA", n_burnin=40, seed=4, chunk_size=25)
    ckpt = str(tmp_path / "chain.npz")
    mu_ref, b_ref = _sharded(X, y, 2, n_iter=100, **kw)
    _sharded(X, y, 2, n_iter=50, checkpoint_path=ckpt, **kw)  # "crashes" after 50 of 100
    snap = load_state(ckpt)
    assert snap is not None and int(snap["__done__"]) == 50
    mu2, b2 = _sharded(X, y, 2, n_iter=100, checkpoint_path=ckpt, **kw)
    assert mu2 == mu_ref and np.array_equal(b2, b_ref)
    mu3, b3 = _sharded(X, y, 2, n_iter=100, checkpoint_path=ckpt, **kw)  # already complete
    assert abs(mu3 - mu_ref) < 1e-4
    np.testing.assert_allclose(b3, b_ref, atol=1e-5)
    # Segments alone change nothing either.
    mu4, b4 = _sharded(X, y, 2, n_iter=100, model="BayesA", n_burnin=40, seed=4)
    assert mu4 == mu_ref and np.array_equal(b4, b_ref)


def test_sharded_unknown_model_or_schedule(problem):
    X, y = problem
    with pytest.raises(ValueError, match="unknown Bayesian model"):
        _sharded(X, y, 2, model="nope")
    with pytest.raises(ValueError, match="device_schedule"):
        _sharded(X, y, 2, model="BayesC", device_schedule="bogus")


@pytest.fixture(scope="module")
def cv_data():
    genomes = gt.simulate_genomes(n=60, l=150, seed=9)
    trials, _ = gt.simulate_trials(genomes, f_add_dom_epi=np.array([[0.5, 0.0, 0.0]]), seed=9)
    return genomes, gt.extract_phenomes(trials)


def test_gibbs_cv_folds_mesh_pads_and_matches_per_fold(cv_data):
    """F = 5 folds over D = 2 ranks (a dummy sixth fold): every fold's bits
    are those of mesh=None."""
    genomes, phenomes = cv_data
    X = genomes.allele_frequencies.astype(np.float32)
    y = phenomes.phenotypes[:, 0]
    masks = np.ones((5, X.shape[0]), np.float32)
    for f in range(5):
        masks[f, f::5] = 0.0
    kw = dict(model="BayesC", n_iter=16, n_burnin=4, seed=5, block_size=32)
    outs = run_ranks(lambda m: gt.gibbs_cv_folds(X, y, masks, mesh=m, **kw), shape=(1, 2),
                     device=CPU)
    ref = gt.gibbs_cv_folds(X, y, masks, device=CPU, **kw)
    for mu, b in outs:
        assert mu.shape == (5,) and b.shape == (5, X.shape[1])
        assert np.array_equal(mu, ref[0]) and np.array_equal(b, ref[1])


def test_cvbulk_batched_mesh_matches_per_fold(cv_data):
    genomes, phenomes = cv_data
    kw = dict(models=("ridge", "gblup", "lasso", "bayesc"), n_replications=1, n_folds=5,
              mcmc_n_iter=10, mcmc_n_burnin=2)
    outs = run_ranks(lambda m: gt.cvbulk_batched(genomes, phenomes, mesh=m, **kw)[0],
                     shape=(1, 2), device=CPU)
    ref, _ = gt.cvbulk_batched(genomes, phenomes, device=CPU, **kw)
    assert len(ref) == 20
    for cvs in outs:
        assert [(c.fit.model, c.replication, c.fold) for c in cvs] == \
            [(c.fit.model, c.replication, c.fold) for c in ref]
        for a, b in zip(cvs, ref):
            assert np.array_equal(a.y_pred, b.y_pred), (a.fit.model, a.fold)


@pytest.mark.parametrize("fname", ["mult", "addnorm"])
def test_transform2_mesh_matches_single_and_jax(fname):
    """The pair rows over 2 ranks keep the single scan's top-k, and the JAX
    package's `_pairs_topk_sharded` selects the same pairs."""
    from genomicbreedingmodels_tpu.features import transform as tj
    from genomicbreedingmodels_tpu.parallel.mesh import make_mesh as make_mesh_j

    genomes_j = gj.simulate_genomes(n=48, l=300, seed=3)
    trials, _ = gj.simulate_trials(genomes_j, f_add_dom_epi=np.array([[0.3, 0.0, 0.3]]), seed=3)
    phen_j = gj.extract_phenomes(trials)
    g, p = convert.genomes_from_reference(genomes_j), convert.phenomes_from_reference(phen_j)
    f = getattr(gt, fname)
    kw = dict(n_new_features_per_transformation=40)
    outs = run_ranks(lambda m: gt.transform2(f, g, p, mesh=m, **kw), shape=(1, 2), device=CPU)
    ref = gt.transform2(f, g, p, device=CPU, **kw)
    for o in outs:
        assert list(o.loci_alleles) == list(ref.loci_alleles)
        assert np.array_equal(o.allele_frequencies, ref.allele_frequencies)
    out_j = tj.transform2(getattr(gj, fname), genomes_j, phen_j, mesh=make_mesh_j((1, 2)), **kw)
    assert set(map(str, out_j.loci_alleles)) == set(map(str, ref.loci_alleles))
