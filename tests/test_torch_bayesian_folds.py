"""The port's fold-batched Bayesian CV (models/bayesian.py:gibbs_cv_folds, the
Gibbs names of cv/batched.py:cvbulk_batched, and K3's fold axis in its plain
version) held against the JAX package's on numpy-seeded panels and on the
sim_small fixture.

The chains draw from other generators than the JAX chains (threefry), so they
are held by posterior statistics, never draw by draw:
- pinned-variance BRR folds, port and JAX, each against its fold's closed-form
  conjugate posterior mean: cor >= 0.999 (600 sweeps, 100 burn-in);
- a fold of a batch against the same fold run alone with its own generator:
  identical inclusions and effects within 1e-5·max|b| after 5 sweeps (the
  same draws; only the batched products' rounding may differ);
- unpinned BayesC and BRR fold chains against the JAX package's on the same
  inputs: per-fold posterior-mean σ²ₑ within 6 % and ‖b̂‖ within 6 %, pooled
  validation predictions cor >= 0.98 (observed: 2 %, 1.4 % and 0.998; a chain
  that counts n rows where a fold has n_eff = 2n/3 moves σ²ₑ by ~30 %);
- unpinned BL fold chains against an independent float64 single-site BL
  sampler on each fold's training rows, at the same limits (the JAX BL draws
  τ² through an inverse-Gaussian root that cancels in float32 and sits
  10-27 % off in ‖b̂‖, so it is no reference here); the port's
  inverse-Gaussian draw holds E[1/x] = 1/μ + 1/λ to 1 % out to μ/λ = 2e6;
- cvbulk_batched's bayesc against the JAX package's: identical tags and
  validation entries for the same seed, mean validation cor > 0.3 in both;
  the port's `predict` on a JAX-made CV within 1e-6 of the JAX `predict`.
The fold-axis plain K3 is exactly F single plain calls.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import genomicbreedingmodels_tpu as gj
import genomicbreedingmodels_tpu_torch as gt
from genomicbreedingmodels_tpu.models.bayesian import gibbs_cv_folds as gibbs_cv_folds_jax
from genomicbreedingmodels_tpu_torch import convert
from genomicbreedingmodels_tpu_torch.kernels import gibbs_group
from genomicbreedingmodels_tpu_torch.utils import config

bayes = importlib.import_module("genomicbreedingmodels_tpu_torch.models.bayesian")

torch.set_num_threads(2)
CPU = "cpu"
SIG_E, SIG_B = 0.8, 0.05  # the pinned variances
COR_CLOSED = 0.999


@pytest.fixture(scope="module")
def panel():
    """120 × 64 dosage panel, 20 % causal, and three training masks."""
    rng = np.random.default_rng(0)
    n, p = 120, 64
    X = (rng.integers(0, 3, size=(n, p)) / 2).astype(np.float32)
    beta = rng.normal(size=p) * (rng.uniform(size=p) < 0.2)
    y = (X @ beta + rng.normal(size=n)).astype(np.float32)
    labels = rng.integers(0, 3, size=n)
    masks = np.stack([labels != f for f in range(3)]).astype(np.float32)
    return X, y, masks


def _closed_form(X, y, m):
    """The pinned-variance BRR posterior mean of a fold's training rows."""
    Xt, yt = X[m > 0].astype(np.float64), y[m > 0].astype(np.float64)
    Xc, yc = Xt - Xt.mean(0), yt - yt.mean()
    b = np.linalg.solve(Xc.T @ Xc / SIG_E + np.eye(X.shape[1]) / SIG_B, Xc.T @ yc / SIG_E)
    return yt.mean() - Xt.mean(0) @ b, b


@pytest.fixture(scope="module")
def pinned_brr(panel):
    """Both packages' pinned BRR fold chains, each computed once."""
    X, y, masks = panel
    kw = dict(model="BRR", n_iter=600, n_burnin=100, fix_sigma_e2=SIG_E, fix_sigma_b2=SIG_B)
    return {"jax": gibbs_cv_folds_jax(X, y, masks, **kw),
            "port": gt.gibbs_cv_folds(X, y, masks, device=CPU, **kw)}


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_pinned_brr_folds_match_closed_form(panel, pinned_brr, pkg):
    X, y, masks = panel
    mu, b = pinned_brr[pkg]
    assert mu.shape == (3,) and b.shape == (3, X.shape[1]) and b.dtype == np.float64
    for f in range(3):
        mu_ref, b_ref = _closed_form(X, y, masks[f])
        assert np.corrcoef(b[f], b_ref)[0, 1] >= COR_CLOSED
        assert abs(mu[f] - mu_ref) <= 0.05 * np.abs(y).std()


# Unpinned fold chains: both packages (JAX: BayesC, BRR) or the float64
# reference (BL) on one panel, held by per-fold posterior statistics.
SIG_REL, NORM_REL, COR_POOLED = 0.06, 0.06, 0.98
N_ITER, N_BURNIN, BLOCK = 600, 150, 48


@pytest.fixture(scope="module")
def panel_unpinned():
    """240 × 96 dosage panel, 10 % causal, h² ≈ 0.5, three training masks
    (n_eff ≈ 160 of n = 240)."""
    rng = np.random.default_rng(5)
    n, p = 240, 96
    X = (rng.integers(0, 3, size=(n, p)) / 2).astype(np.float32)
    beta = rng.normal(size=p) * (rng.uniform(size=p) < 0.1)
    g = X @ beta
    y = (g + rng.normal(size=n) * g.std()).astype(np.float32)
    labels = rng.integers(0, 3, size=n)
    return X, y, np.stack([labels != f for f in range(3)]).astype(np.float32)


class _RecordingJax:
    """The JAX package's `jax` module, recording what its vmaps return: the
    fold chains' vmap returns (mu, b, traces) before gibbs_cv_folds keeps
    the first two, so the σ²ₑ trace is read from the same run."""

    def __init__(self, jax):
        self._jax, self.outputs = jax, []

    def __getattr__(self, name):
        return getattr(self._jax, name)

    def vmap(self, fn, *args, **kwargs):
        batched = self._jax.vmap(fn, *args, **kwargs)

        def run(*a, **kw):
            out = batched(*a, **kw)
            self.outputs.append(out)
            return out

        return run


def _jax_fold_chains(X, y, masks, model, seed):
    """JAX gibbs_cv_folds: (mu (F,), b (F, p), posterior-mean σ²ₑ (F,))."""
    jb = importlib.import_module("genomicbreedingmodels_tpu.models.bayesian")
    rec = _RecordingJax(jb.jax)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jb, "jax", rec)
        mu, b = gibbs_cv_folds_jax(X, y, masks, model=model, n_iter=N_ITER, n_burnin=N_BURNIN,
                                   seed=seed, block_size=BLOCK)
    sig = np.asarray(rec.outputs[-1][2][0], dtype=np.float64)  # (F, n_iter)
    assert sig.shape == (masks.shape[0], N_ITER)
    return mu, b, sig[:, N_BURNIN:].mean(1)


def _port_fold_chains(X, y, masks, model, seed):
    """The port's fold chains: (mu (F,), b (F, p), posterior-mean σ²ₑ (F,))."""
    seeds = [bayes._fold_seed(seed, f) for f in range(masks.shape[0])]
    mu, b, sig, _ = bayes._fold_chains(X, y, masks, seeds, model, N_ITER, N_BURNIN, BLOCK, 0.5,
                                       None, None, torch.device(CPU))
    return mu, b, sig[N_BURNIN:].mean(0)


def _bl_reference(X, y, m, seed, r2=0.5):
    """BL on a fold's training rows by single-site Gibbs in float64, written
    from the model (BGLR's priors, Park & Casella's τ² and λ² draws) and
    numpy's inverse-Gaussian sampler; the hyperparameters come from the full
    panel, as gibbs_cv_folds takes them. Returns (mu, b, posterior-mean σ²ₑ)."""
    rng = np.random.default_rng(seed)
    var_y, ms_x, p_all = float(np.var(y, ddof=1)), float(np.sum(np.var(X, axis=0))), X.shape[1]
    df_e, df_b = 5.0, 5.0
    S_e0 = var_y * (1.0 - r2) * (df_e + 2.0)
    lam2_0 = 2.0 * (1.0 - r2) / r2 * ms_x / p_all
    Xt, yt = X[m > 0].astype(np.float64), y[m > 0].astype(np.float64)
    Z = Xt - Xt.mean(0)
    n, p = Z.shape
    x2 = (Z * Z).sum(0)
    b, mu = np.zeros(p), yt.mean()
    r = yt - mu
    sig, lam2 = r @ r / n * 0.5, lam2_0
    s2 = np.full(p, var_y * r2 / ms_x * (df_b + 2.0) / (df_b - 2.0))
    acc_b, acc_mu, acc_sig = np.zeros(p), 0.0, 0.0
    for it in range(N_ITER):
        e = rng.standard_normal(p)
        for j in range(p):
            r += Z[:, j] * b[j]
            prec = x2[j] / sig + 1.0 / s2[j]
            b[j] = Z[:, j] @ r / sig / prec + e[j] / np.sqrt(prec)
            r -= Z[:, j] * b[j]
        d = r.mean() + np.sqrt(sig / n) * rng.standard_normal()
        mu, r = mu + d, r - d
        sig = (r @ r + S_e0) / rng.chisquare(df_e + n)
        inv_tau2 = rng.wald(np.sqrt(lam2 * sig / np.maximum(b * b, 1e-12)), lam2)
        s2 = np.clip(sig / np.maximum(inv_tau2, 1e-12), 1e-10, 1e6)
        lam2 = np.clip(rng.gamma(p_all + 1.1) / (0.5 * (s2 / sig).sum() + 1.1 / lam2_0),
                       1e-10, 1e10)
        if it >= N_BURNIN:
            acc_b, acc_mu, acc_sig = acc_b + b, acc_mu + mu, acc_sig + sig
    k = N_ITER - N_BURNIN
    return acc_mu / k - Xt.mean(0) @ (acc_b / k), acc_b / k, acc_sig / k


@pytest.mark.parametrize("model", ["BayesC", "BRR", "BL"])
def test_unpinned_fold_chains_match_reference(panel_unpinned, model):
    """Unpinned row-masked fold chains held by posterior statistics against
    the JAX package's (BayesC, BRR) or the float64 BL sampler (BL)."""
    X, y, masks = panel_unpinned
    mu, b, sig = _port_fold_chains(X, y, masks, model, seed=1)
    if model == "BL":
        ref = [_bl_reference(X, y, masks[f], seed=10 + f) for f in range(3)]
        mu_r, b_r, sig_r = (np.array([r[i] for r in ref]) for i in range(3))
    else:
        mu_r, b_r, sig_r = _jax_fold_chains(X, y, masks, model, seed=1)
    np.testing.assert_array_less(np.abs(sig / sig_r - 1.0), SIG_REL)
    np.testing.assert_array_less(np.abs(np.linalg.norm(b, axis=1) / np.linalg.norm(b_r, axis=1) - 1.0),
                                 NORM_REL)
    val = masks == 0
    pred = np.concatenate([mu[f] + X[val[f]] @ b[f] for f in range(3)])
    pred_r = np.concatenate([mu_r[f] + X[val[f]] @ b_r[f] for f in range(3)])
    assert np.corrcoef(pred, pred_r)[0, 1] >= COR_POOLED


@pytest.mark.parametrize("lam", [0.05, 1.0, 30.0])
def test_inverse_gaussian_draw(lam):
    """BL's τ² draw: IG(μ, λ) has E[1/x] = 1/μ + 1/λ. Held to 1 % over
    2·10⁶ draws from μ/λ = 0.01 to 2·10⁶, every draw finite and positive."""
    gen = torch.Generator().manual_seed(4)
    N = 2_000_000
    for mu in (0.3, 10.0, 1e3, 1e5):
        v = torch.randn(N, generator=gen) ** 2
        x = bayes._inverse_gaussian(torch.full((N,), mu), lam, v, torch.rand(N, generator=gen))
        assert bool(torch.isfinite(x).all()) and bool((x > 0).all())
        inv_mean = float((1.0 / x.double()).mean())
        assert abs(inv_mean / (1.0 / mu + 1.0 / lam) - 1.0) < 0.01, (mu, lam, inv_mean)


def test_masked_intercept_draws_its_fold_posterior(panel):
    """With pinned variances a fold's centered intercept is drawn afresh each
    sweep from N(ȳ_f, σ²ₑ/n_eff) (its centered columns are orthogonal to the
    intercept on the training rows). Over 2000 sweeps its sample variance
    is held to 12 % of σ²ₑ/n_eff (sampling sd 3.2 %) and its mean to four
    standard errors of ȳ_f: a draw that divides by n where it should divide
    by n_eff (n_eff = 2n/3 here) is an AR(1) with 25 % less variance."""
    X, y, masks = panel
    T = 2000
    seeds = [bayes._fold_seed(5, f) for f in range(3)]
    _, _, _, mu_tr = bayes._fold_chains(X, y, masks, seeds, "BRR", T, 0, 64, 0.5, SIG_E, SIG_B,
                                        torch.device(CPU))
    for f in range(3):
        n_eff = masks[f].sum()
        var = SIG_E / n_eff
        assert abs(mu_tr[:, f].var() / var - 1.0) < 0.12, f
        assert abs(mu_tr[:, f].mean() - y[masks[f] > 0].mean()) < 4.0 * np.sqrt(var / T), f


@pytest.mark.parametrize("model,update", [("BayesC", "auto"), ("BayesC", "pallas"),
                                          ("BayesC", "scalar"), ("BayesB", "auto"),
                                          ("BRR", "auto"), ("BL", "auto"), ("BayesA", "auto")])
def test_fold_of_a_batch_is_the_fold_alone(panel, model, update):
    """Fold f of the batch against fold f run by itself with the generator
    seeded from (seed, f): 5 sweeps, the last one kept (burn-in 4)."""
    X, y, masks = panel
    cfg = config.get_config()
    config.set_config(dataclasses.replace(cfg, mcmc_indicator_update=update))
    try:
        kw = dict(n_iter=5, n_burnin=4, block_size=32, r2=0.5, fix_sigma_e2=None,
                  fix_sigma_b2=None, dev=torch.device(CPU))
        seeds = [bayes._fold_seed(7, f) for f in range(3)]
        _, b, _, _ = bayes._fold_chains(X, y, masks, seeds, model, **kw)
        for f in range(3):
            _, b1, _, _ = bayes._fold_chains(X, y, masks[f : f + 1], seeds[f : f + 1], model, **kw)
            if model in ("BayesC", "BayesB"):
                assert np.array_equal(b1[0] != 0, b[f] != 0)
            np.testing.assert_allclose(b1[0], b[f], rtol=0, atol=1e-5 * np.abs(b[f]).max())
    finally:
        config.set_config(cfg)


def test_fold_axis_plain_k3_is_single_calls():
    """K3's plain version (and the wrapper on CPU tensors) with a leading fold
    axis, strided folds included, equals F single calls exactly."""
    rng = np.random.default_rng(3)
    F, bs, K, n = 3, 60, 6, 80
    G = bs // K
    Xs = rng.normal(size=(F, n, bs)).astype(np.float32)
    Cb = torch.from_numpy(np.einsum("fni,fnj->fij", Xs, Xs))
    u = torch.from_numpy(rng.normal(size=(F, bs)).astype(np.float32))
    state = torch.from_numpy(rng.normal(size=(F, 2 * bs)).astype(np.float32))
    b = state[:, :bs] * (state[:, :bs] > 1.0)  # an (F, 2·bs) state's block: fold stride 2·bs
    s2 = torch.from_numpy(rng.uniform(0.01, 0.1, size=(F, 2 * bs)).astype(np.float32))[:, bs:]
    val = torch.ones(bs)
    val[-4:] = 0.0
    eta = torch.from_numpy(rng.normal(size=(F, bs)).astype(np.float32))
    gum = torch.from_numpy(rng.gumbel(size=(F, G, 1 << K)).astype(np.float32))
    sig, pi = torch.tensor([0.9, 1.3, 0.7]), torch.tensor([0.1, 0.3, 0.05])
    args = (Cb, u, b, s2, val, eta, gum, sig, pi)
    before = gibbs_group.LAUNCHES["gibbs_group"]
    outs = [gibbs_group.grouped_block_update_plain(*args, K=K),
            gibbs_group.grouped_block_update(*args, K=K)]
    assert gibbs_group.LAUNCHES["gibbs_group"] == before  # CPU tensors launch nothing
    for f in range(F):
        one = gibbs_group.grouped_block_update_plain(Cb[f], u[f], b[f], s2[f], val, eta[f], gum[f],
                                                     sig[f], pi[f], K=K)
        for out in outs:
            for x, r in zip(out, one):
                assert torch.equal(x[f], r)


def test_k3_wrapper_checks_contiguity_per_fold():
    """Unbatched, the whole block must be contiguous (a (bs, bs) slice of a
    wider Gram is refused); with a fold axis each fold must be, at any fold
    stride."""
    bs, K = 12, 6
    wide = torch.zeros(bs, 2 * bs)
    args = [wide[:, :bs], torch.zeros(bs), torch.zeros(bs), torch.ones(bs), torch.ones(bs),
            torch.zeros(bs), torch.zeros(bs // K, 1 << K), torch.tensor(1.0), torch.tensor(0.1)]
    with pytest.raises(ValueError, match="Cb must be contiguous"):
        gibbs_group.grouped_block_update(*args, K=K)
    folded = [torch.zeros(2, bs, bs)] + [torch.zeros(2, 2 * bs)[:, :bs] for _ in range(3)]
    fargs = folded + [torch.ones(bs), torch.zeros(2, bs), torch.zeros(2, bs // K, 1 << K),
                      torch.ones(2), torch.full((2,), 0.1)]
    assert gibbs_group.grouped_block_update(*fargs, K=K)[0].shape == (2, bs)
    fargs[1] = torch.zeros(2, 2 * bs)[:, ::2]  # not contiguous within a fold
    with pytest.raises(ValueError, match="u must be contiguous"):
        gibbs_group.grouped_block_update(*fargs, K=K)


def test_k3_fold_workspace_and_cap():
    """The workspace grows to F slices of tables and F × builders flags; one
    launch takes at most half the SMs' worth of folds."""
    dev = torch.device(CPU)
    lay = gibbs_group.k3_layout(258, 6)
    gibbs_group._WORKSPACES.pop((dev, 7), None)
    try:
        t, fl, e = gibbs_group._workspace(dev, 7, lay, folds=15)
        assert t.numel() == 15 * lay.table_floats and fl.numel() == 15 * lay.builders
        t1, fl1, e1 = gibbs_group._workspace(dev, 7, lay, folds=1)  # a smaller launch keeps it
        assert t1 is t and fl1 is fl and e1 == e + 1
    finally:
        gibbs_group._WORKSPACES.pop((dev, 7), None)
    assert gibbs_group.folds_per_launch(132) == 66 and gibbs_group.folds_per_launch(1) == 1


def test_hoist_gates_count_every_chain():
    """The hoisted tables of F chains are counted in total (JAX batch_hint);
    the joint-draw tables of one chain keep the reference's 1e8-float gate,
    fold chains have 2.5e8."""
    assert bayes._hoists("BRR", 256, 256 * 128, 0, False, chains=15) == (False, True)
    assert bayes._hoists("BRR", 256, 256 * 128, 0, False, chains=60) == (False, False)
    assert bayes._hoists("BRR", 256, 256 * 1536, 0, False) == (False, False)  # 1.006e8 floats
    assert bayes._hoists("BRR", 256, 256 * 768, 0, False, chains=2) == (False, True)
    p_pad = 258 * 128
    assert bayes._hoists("BayesC", 258, p_pad, 6, False, chains=15)[0]
    assert not bayes._hoists("BayesC", 258, p_pad, 6, False, chains=200)[0]


def test_gibbs_cv_folds_checks(panel):
    X, y, masks = panel
    # A mesh of one rank runs the folds as mesh=None does, bit for bit.
    from genomicbreedingmodels_tpu_torch.parallel.mesh import run_ranks

    kw = dict(model="BayesC", n_iter=12, n_burnin=4, seed=3)
    (one,) = run_ranks(lambda m: gt.gibbs_cv_folds(X, y, masks, mesh=m, **kw), shape=(1, 1),
                       device=CPU)
    ref = gt.gibbs_cv_folds(X, y, masks, device=CPU, **kw)
    assert all(np.array_equal(a, b) for a, b in zip(one, ref))
    with pytest.raises(ValueError, match="fold_masks"):
        gt.gibbs_cv_folds(X, y, masks[:, :10], device=CPU)
    with pytest.raises(ValueError, match=">= 2 training rows"):
        gt.gibbs_cv_folds(X, y, np.zeros((2, X.shape[0])), device=CPU)
    with pytest.raises(ValueError, match="unknown Bayesian model"):
        gt.gibbs_cv_folds(X, y, masks, model="BayesZ", device=CPU)
    with pytest.raises(ValueError, match="together"):
        gt.gibbs_cv_folds(X, y, masks, fix_sigma_e2=1.0, device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            gt.gibbs_cv_folds(X, y, masks)


@pytest.fixture(scope="module")
def cv_runs(sim_small):
    """Both packages' cvbulk_batched over ("bayesc", "ridge"), 1 × 3 folds,
    100 sweeps (30 burn-in), seed 3."""
    genomes, phenomes, _ = sim_small
    kw = dict(models=("bayesc", "ridge"), n_replications=1, n_folds=3, seed=3, mcmc_n_iter=100,
              mcmc_n_burnin=30)
    cj, nj = gj.cvbulk_batched(genomes, phenomes, **kw)
    g, p = convert.genomes_from_reference(genomes), convert.phenomes_from_reference(phenomes)
    ct, nt = gt.cvbulk_batched(g, p, device=CPU, **kw)
    return cj, nj, ct, nt, genomes, g


def test_cvbulk_batched_gibbs_matches_jax(cv_runs):
    cj, nj, ct, nt, _, _ = cv_runs
    keys = [(cv.fit.trait, cv.fit.model, cv.replication, cv.fold) for cv in ct]
    assert keys == [(cv.fit.trait, cv.fit.model, cv.replication, cv.fold) for cv in cj]
    assert nt == nj and len(ct) == 6
    for a, b in zip(ct, cj):
        assert a.checkdims()
        assert np.array_equal(a.validation_entries, b.validation_entries)
        assert np.array_equal(a.fit.entries, b.fit.entries)
        assert a.fit.extras["engine"] == b.fit.extras["engine"]
    for cvs in (ct, cj):
        assert np.mean([cv.metrics["cor"] for cv in cvs if cv.fit.model == "bayesc"]) > 0.3
    from genomicbreedingmodels_tpu_torch.cv import batched
    stages = batched.LAST_TIMER.summary()
    assert "bayesc_solve" in stages and "bayesc_emit" in stages


def test_batched_gibbs_fits_predict(cv_runs):
    """The port's fold fits predict their validation entries as the CV
    recorded; a JAX-made CV converted with cv_from_reference predicts
    through the port as through the JAX package."""
    cj, _, ct, _, genomes, g = cv_runs
    for cv in ct:
        if cv.fit.model != "bayesc":
            continue
        idx = g.entry_indices(cv.validation_entries.tolist())
        pred = gt.predict(cv.fit, g, idx, device=CPU)
        np.testing.assert_allclose(pred, cv.y_pred, rtol=0, atol=1e-6 * np.abs(cv.y_pred).max())
    for cvj in cj:
        if cvj.fit.model != "bayesc":
            continue
        idx = genomes.entry_indices(cvj.validation_entries.tolist())
        ref = gj.predict(cvj.fit, genomes, idx)
        pred = gt.predict(convert.cv_from_reference(cvj).fit, g, idx, device=CPU)
        np.testing.assert_allclose(pred, ref, rtol=0, atol=1e-6 * np.abs(ref).max())
