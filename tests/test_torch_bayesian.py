"""The port's Bayesian alphabet (models/bayesian.py) held against the JAX
sampler and closed-form posteriors, plus its public API, segmented chains
and dispatch.

Torch's generators are not JAX's threefry, so no test asserts that two
packages' chains are equal: chains are compared by posterior statistics.
K3's kernel-level agreement (shared noise) and the grouped draw against the
scalar oracle are in tests/test_torch_gibbs_kernel.py.
Every input is made with numpy from a seed and handed to both packages.
"""

import numpy as np
import pytest
import torch

import genomicbreedingmodels_tpu as gj
import genomicbreedingmodels_tpu_torch as gt
from genomicbreedingmodels_tpu.models.bayesian import gibbs_regression as gibbs_jax
from genomicbreedingmodels_tpu_torch import convert
from genomicbreedingmodels_tpu_torch.models.bayesian import gibbs_regression
from genomicbreedingmodels_tpu_torch.utils import config

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # This host's intra-op thread pool is far slower than one thread on the
    # chain's small tensors.
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def strong_additive():
    genomes = gj.simulate_genomes(n=100, l=300, seed=42)
    trials, effects = gj.simulate_trials(
        genomes, f_add_dom_epi=np.array([[0.5, 0.0, 0.0]]), seed=42
    )
    phenomes = gj.extract_phenomes(trials)
    return genomes, phenomes, effects


def _sim_xy(n, p, seed=5, h2=0.6, k=20):
    """tests/test_parity_oracles.py's simulator."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(0.0, 1.0, size=(n, p))
    idx = rng.choice(p, min(k, p), replace=False)
    b = rng.normal(size=len(idx))
    g = X[:, idx] @ b
    g = (g - g.mean()) / g.std()
    y = np.sqrt(h2) * g + np.sqrt(1 - h2) * rng.normal(size=n)
    return X, y


def test_pinned_brr_matches_conjugate_posterior():
    """tests/test_parity_oracles.py::test_brr_pinned_posterior_mean_converges
    on the port: with σ²ₑ and σ²_b pinned the effect posterior is Gaussian
    with a closed-form mean; the Monte-Carlo error shrinks with T."""
    n, p = 60, 40
    X, y = _sim_xy(n=n, p=p, seed=13, k=10)
    sig_e2, sig_b2 = 0.5, 0.05
    Z = X - X.mean(axis=0)
    b_star = np.linalg.solve(Z.T @ Z / sig_e2 + np.eye(p) / sig_b2, Z.T @ y / sig_e2)
    errs, fits = {}, {}
    for T in (250, 4000):
        mu_hat, b_hat, diag = gibbs_regression(
            X, y, model="BRR", n_iter=200 + T, n_burnin=200, seed=17,
            fix_sigma_e2=sig_e2, fix_sigma_b2=sig_b2, device=CPU,
        )
        assert diag["update"] == "joint-hoisted"
        errs[T], fits[T] = np.linalg.norm(b_hat - b_star), (mu_hat, b_hat)
    assert errs[4000] < errs[250]
    assert errs[4000] < 0.1 * np.linalg.norm(b_star)
    mu_hat, b_hat = fits[4000]
    yhat_o = (y.mean() - X.mean(axis=0) @ b_star) + X @ b_star
    assert np.corrcoef(mu_hat + X @ b_hat, yhat_o)[0, 1] >= 0.999


def test_pinned_bayesc_in_step_grouped_near_conjugate_posterior():
    """BayesC on its in-step grouped path (K3's plain version, which
    indicator_update="pallas" runs on a CPU tensor) under the same pinning.
    Its spike-and-slab posterior mean is not the ridge mean: it shrinks the
    small effects to zero, so the bound is 0.99 on the GEBV correlation
    (measured 0.995 at T=250 and T=2000), not 0.999."""
    X, y = _sim_xy(n=60, p=40, seed=13, k=10)
    sig_e2, sig_b2 = 0.5, 0.05
    Z = X - X.mean(axis=0)
    b_star = np.linalg.solve(Z.T @ Z / sig_e2 + np.eye(40) / sig_b2, Z.T @ y / sig_e2)
    mu_hat, b_hat, diag = gibbs_regression(
        X, y, model="BayesC", n_iter=1200, n_burnin=200, seed=17,
        fix_sigma_e2=sig_e2, fix_sigma_b2=sig_b2, indicator_update="pallas", device=CPU,
    )
    assert diag["update"] == "pallas"
    yhat_o = (y.mean() - X.mean(axis=0) @ b_star) + X @ b_star
    assert np.corrcoef(mu_hat + X @ b_hat, yhat_o)[0, 1] >= 0.99


@pytest.mark.parametrize("model", ["BayesC", "BRR"])
def test_port_matches_jax_by_posterior_statistics(strong_additive, model):
    """Same panel and response into both packages: posterior-mean GEBVs
    correlate >= 0.99 and the σ²ₑ posterior means agree within 25 %."""
    genomes, phenomes, _ = strong_additive
    X, y = genomes.allele_frequencies, phenomes.phenotypes[:, 0]
    kw = dict(model=model, n_iter=600, n_burnin=150, seed=3)
    mu_j, b_j, d_j = gibbs_jax(X, y, **kw)
    mu_t, b_t, d_t = gibbs_regression(X, y, device=CPU, **kw)
    assert np.corrcoef(mu_t + X @ b_t, mu_j + X @ b_j)[0, 1] >= 0.99
    s2_j = d_j["sigma_e2_trace"][150:].mean()
    s2_t = d_t["sigma_e2_trace"][150:].mean()
    assert abs(s2_t - s2_j) / s2_j < 0.25


def test_segmented_chain_is_bit_identical_and_resumable(tmp_path):
    """After tests/test_bayesian.py::test_segmented_chain_is_bit_identical_and_resumable:
    the generator's state rides in the chain state, so segments equal one
    run bit for bit, and a checkpoint resume reproduces it."""
    rng = np.random.default_rng(0)
    X = rng.random((80, 200)).astype(np.float32)
    b_true = np.zeros(200)
    b_true[:4] = [1, -1, 0.5, 2]
    y = X @ b_true + 0.3 * rng.normal(size=80)
    kw = dict(model="BayesC", n_burnin=60, seed=3, device=CPU)
    mu1, b1, d1 = gibbs_regression(X, y, n_iter=160, **kw)
    mu2, b2, d2 = gibbs_regression(X, y, n_iter=160, chunk_size=45, **kw)
    assert mu1 == mu2
    assert np.array_equal(b1, b2)
    assert np.array_equal(d1["sigma_e2_trace"], d2["sigma_e2_trace"])
    ck = str(tmp_path / "chain.npz")
    gibbs_regression(X, y, n_iter=80, chunk_size=40, checkpoint_path=ck, **kw)  # "crash" at 80
    snap = np.load(ck)
    assert int(snap["__done__"]) == 80 and snap["s7"].dtype == np.uint8
    mu3, b3, d3 = gibbs_regression(X, y, n_iter=160, chunk_size=40, checkpoint_path=ck, **kw)
    assert mu3 == mu1
    assert np.array_equal(b3, b1)
    # the resumed call traces only the sweeps it ran
    assert np.array_equal(d3["sigma_e2_trace"], d1["sigma_e2_trace"][80:])


@pytest.mark.parametrize("fn,name", [
    (gt.bayesa, "bayesa"), (gt.bayesb, "bayesb"), (gt.bayesc, "bayesc"),
    (gt.bayesian_ridge, "bayesian_ridge"), (gt.bayesian_lasso, "bayesian_lasso"),
    (gt.bayesian_lasso_pi, "bayesian_lasso_pi"), (gt.bayest, "bayest"), (gt.bayestpi, "bayestpi"),
])
def test_alphabet_functions_fit_and_predict(strong_additive, fn, name):
    genomes, phenomes, _ = strong_additive
    g = convert.genomes_from_reference(genomes)
    p = convert.phenomes_from_reference(phenomes)
    fit = fn(g, p, idx_entries=np.arange(90), n_iter=150, n_burnin=50, device=CPU)
    assert fit.model == name and fn.__name__ == name
    assert fit.checkdims() and fit.b_hat_labels[0] == "intercept"
    assert len(fit.b_hat) == genomes.p + 1 and np.all(np.isfinite(fit.b_hat))
    assert fit.metrics["cor"] > 0.5
    continuous = name in ("bayesa", "bayesian_ridge", "bayest")  # no indicator, not BL
    assert fit.extras["update"] == ("joint-hoisted" if continuous else "grouped-hoisted")
    yhat = gt.predict(fit, g, np.arange(90, 100), device=CPU)
    assert yhat.shape == (10,) and np.all(np.isfinite(yhat))


def test_bglr_and_ordinal_response():
    rng = np.random.default_rng(0)
    n, p = 150, 120
    X = rng.random((n, p)).astype(np.float32)
    b_true = np.zeros(p)
    b_true[[3, 60, 100]] = [2.0, -1.5, 1.8]
    liab = X @ b_true
    liab = (liab - liab.mean()) / liab.std()
    b = gt.bglr(X, liab + 0.3 * rng.normal(size=n), model="BayesC", n_iter=300, n_burnin=100,
                device=CPU)
    assert b.shape == (p + 1,)
    assert np.corrcoef(b[0] + X @ b[1:], liab)[0, 1] > 0.8
    y3 = np.digitize(liab + 0.4 * rng.normal(size=n), [-0.5, 0.5]).astype(float)
    mu, b3, diag = gibbs_regression(X, y3, model="BayesC", n_iter=400, n_burnin=150,
                                    response_type="ordinal", device=CPU)
    assert np.corrcoef(mu + X @ b3, liab)[0, 1] > 0.6
    assert np.all(diag["sigma_e2_trace"] == 1.0)  # probit identification
    with pytest.raises(ValueError):
        gibbs_regression(X, y3, response_type="poisson", device=CPU)
    with pytest.raises(ValueError):
        gibbs_regression(X, np.ones(n), response_type="ordinal", device=CPU)


def test_jax_fit_predicts_identically_through_the_port(strong_additive):
    genomes, phenomes, _ = strong_additive
    fj = gj.bayesc(genomes, phenomes, idx_entries=np.arange(90), n_iter=120, n_burnin=40)
    fit = convert.fit_from_reference(fj)
    assert fit.model == "bayesc" and fit.checkdims()
    idx = np.arange(90, 100)
    pj = gj.predict(fj, genomes, idx)
    pt = gt.predict(fit, convert.genomes_from_reference(genomes), idx, device=CPU)
    assert np.abs(pt - pj).max() <= 1e-5 * max(1.0, np.abs(pj).max())


def test_dispatch():
    rng = np.random.default_rng(1)
    X = rng.random((40, 30)).astype(np.float32)
    y = X[:, 0] + 0.1 * rng.normal(size=40)
    # "auto" with block_size < 8 runs (grouped on the host, K = block_size).
    mu, b, diag = gibbs_regression(X, y, model="BayesC", n_iter=20, n_burnin=5, block_size=4,
                                   device=CPU)
    assert diag["update"] == "grouped-hoisted" and np.all(np.isfinite(b))
    # "auto" is the plain grouped draw off CUDA; non-indicator models ignore it.
    assert gibbs_regression(X, y, model="BRR", n_iter=5, n_burnin=1, device=CPU)[2]["update"] == \
        "joint-hoisted"
    assert gibbs_regression(X, y, model="BL", n_iter=5, n_burnin=1, indicator_update="pallas",
                            device=CPU)[2]["update"] == "scalar"
    with pytest.raises(ValueError, match="indicator_update"):
        gibbs_regression(X, y, model="BayesC", n_iter=5, indicator_update="nope", device=CPU)
    with pytest.raises(ValueError, match="unknown Bayesian model"):
        gibbs_regression(X, y, model="BayesZ", device=CPU)
    with pytest.raises(ValueError, match="together"):
        gibbs_regression(X, y, model="BRR", n_iter=5, fix_sigma_e2=1.0, device=CPU)
    cfg = config.get_config()
    try:
        config.set_config(config.GBMConfig(mcmc_group_size=9))
        with pytest.raises(ValueError, match="K <= 8"):
            gibbs_regression(X, y, model="BayesC", n_iter=5, indicator_update="pallas", device=CPU)
        assert gibbs_regression(X, y, model="BayesC", n_iter=5, n_burnin=1, block_size=18,
                                device=CPU)[2]["update"] == "grouped-hoisted"
    finally:
        config.set_config(cfg)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            gibbs_regression(X, y, model="BayesC", n_iter=5)


def test_multichain_and_host_panel_cache():
    rng = np.random.default_rng(2)
    X = rng.random((50, 64)).astype(np.float32)
    y = X[:, :3].sum(1) + 0.2 * rng.normal(size=50)
    mu, b, diag = gibbs_regression(X, y, model="BayesC", n_iter=60, n_burnin=20, n_chains=2,
                                   device=CPU)
    assert np.isfinite(mu) and b.shape == (64,)
    assert diag["rhat_sigma_e2"] > 0 and set(diag["stage_seconds"]) == {"prep", "sweeps"}
    # A repeated host panel reuses the cached centered panel: same chain.
    again = gibbs_regression(X, y, model="BayesC", n_iter=60, n_burnin=20, n_chains=2, device=CPU)
    assert again[0] == mu and np.array_equal(again[1], b)
    # A tensor panel is copied, never centered in place.
    Xt = torch.from_numpy(X.copy())
    mu_t, b_t, _ = gibbs_regression(Xt, y, model="BayesC", n_iter=60, n_burnin=20, n_chains=2,
                                    device=CPU)
    assert torch.equal(Xt, torch.from_numpy(X))
    assert np.corrcoef(X @ b_t, X @ b)[0, 1] > 0.99
