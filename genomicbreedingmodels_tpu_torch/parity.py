"""Measured accuracy-parity ledger of the port against independent f64
host oracles, torch port of genomicbreedingmodels_tpu/parity.py.

The reference binary (Julia + R/BGLR) does not run here, so the contract is
a suite of plain-numpy f64 oracles implementing the reference backends'
math (glmnet's coordinate descent, conjugate Gaussian posteriors, the
dense-pinv REML objective of reference src/gwas.jl:464-482). The port keeps
its own copy of those oracles (this module; the JAX package's copy is not
imported). `run_parity_ledger` measures each of the port's models on
`device` against its oracle and emits one JSON row per model, with the JAX
ledger's rows, names and thresholds.

Every row: {"model", "quantity", "value", "threshold", "pass", "oracle"}.
The quick rows take seconds on the host; the full ledger about a minute.
"""

from __future__ import annotations

import json
from typing import Callable, List

import numpy as np

__all__ = ["run_parity_ledger"]


def _sim_xy(n, p, seed=5, h2=0.6, k=20):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0.0, 1.0, size=(n, p))
    idx = rng.choice(p, min(k, p), replace=False)
    b = rng.normal(size=len(idx))
    g = X[:, idx] @ b
    g = (g - g.mean()) / g.std()
    y = np.sqrt(h2) * g + np.sqrt(1 - h2) * rng.normal(size=n)
    return X, y


def _cor(a, b) -> float:
    return float(np.corrcoef(np.asarray(a, np.float64), np.asarray(b, np.float64))[0, 1])


def _row(model, quantity, value, threshold, oracle):
    return {
        "model": model,
        "quantity": quantity,
        "value": round(float(value), 6),
        "threshold": threshold,
        "pass": bool(value >= threshold),
        "oracle": oracle,
    }


# --------------------------------------------------------------------------
# f64 oracles (self-contained copies of the JAX package's, parity.py)
# --------------------------------------------------------------------------


def _ridge_oracle(X, y, lam):
    n, p = X.shape
    mx = X.mean(axis=0)
    Z = X - mx
    yc = y - y.mean()
    b = np.linalg.solve(Z.T @ Z + n * lam * np.eye(p), Z.T @ yc)
    return y.mean() - mx @ b, b


def _cd_lasso(Z, yc, lam, tol=1e-10, max_sweeps=20_000):
    """Cyclic coordinate descent on (1/2n)‖yc − Zb‖² + λ‖b‖₁ (glmnet's
    algorithm, reference src/linear.jl:333-360), f64 to convergence."""
    n, p = Z.shape
    col_sq = (Z * Z).sum(axis=0) / n
    b = np.zeros(p)
    r = yc.copy()
    for _ in range(max_sweeps):
        delta = 0.0
        for j in range(p):
            if col_sq[j] <= 0:
                continue
            rho = Z[:, j] @ r / n + col_sq[j] * b[j]
            bj = np.sign(rho) * max(abs(rho) - lam, 0.0) / col_sq[j]
            if bj != b[j]:
                r -= Z[:, j] * (bj - b[j])
                delta = max(delta, abs(bj - b[j]))
                b[j] = bj
        if delta < tol:
            break
    return b


def _conjugate_posterior_mean(X, y, sig_e2, sig_b2):
    Z = X - X.mean(axis=0)
    A = Z.T @ Z / sig_e2 + np.eye(X.shape[1]) / sig_b2
    b = np.linalg.solve(A, Z.T @ y / sig_e2)
    return (y.mean() - X.mean(axis=0) @ b), b


def _reml_neg_loglik(theta, y, Xf, K):
    """Reference REML objective via dense pinv (src/gwas.jl:464-482)."""
    n = len(y)
    V = theta[1] * K + theta[0] * np.eye(n)
    Vinv = np.linalg.pinv(V)
    XtVX = Xf.T @ Vinv @ Xf
    sign, logdet_x = np.linalg.slogdet(XtVX)
    signv, logdet_v = np.linalg.slogdet(V)
    if sign <= 0 or signv <= 0:
        return np.inf
    XtVy = Xf.T @ Vinv @ y
    sol = np.linalg.solve(XtVX, XtVy)
    yPy = y @ Vinv @ y - XtVy @ sol
    return 0.5 * logdet_v + yPy + logdet_x


def _psd64(A):
    A = np.asarray(A, np.float64)
    return 0.5 * (A + A.T)


def _pc1_oracle(K):
    """Exact f64 PC1 of the GRM's column covariance — the same covariate
    definition as models/gwas.py:_grm_pc1_device (which uses 50-step power
    iteration on device) but via a full eigh. Sign-arbitrary; the scan
    statistics are invariant to covariate sign."""
    Kc = K - K.mean(axis=1, keepdims=True)
    C = Kc @ Kc.T / max(K.shape[1] - 1, 1)
    _, U = np.linalg.eigh(C)
    return U[:, -1]


def _pattern_search_2d(f, x0, lo=-6.0, hi=0.0, step=0.5, n_scales=9):
    x = np.array(x0, np.float64)
    fx = f(x)
    for _ in range(n_scales):
        improved = True
        while improved:
            improved = False
            for d in ((step, 0), (-step, 0), (0, step), (0, -step)):
                cand = np.clip(x + d, lo, hi)
                fc = f(cand)
                if fc < fx:
                    x, fx = cand, fc
                    improved = True
        step *= 0.5
    return x


def _oracle_reml_z(y, G, K, marker_idx, grid_pts=14):
    """Per-marker REML z by dense-pinv grid + pattern search, all f64 — no
    eigen-rotation anywhere (independent of the library's algorithm)."""
    n = len(y)
    ones = np.ones(n)
    lg = np.linspace(-5.0, 0.0, grid_pts)
    thetas = [(10.0 ** a, 10.0 ** b) for a in lg for b in lg]
    grid_vals = np.full((len(thetas), len(marker_idx)), np.inf)
    for ti, th in enumerate(thetas):
        V = th[1] * K + th[0] * np.eye(n)
        Vinv = np.linalg.pinv(V)
        signv, logdet_v = np.linalg.slogdet(V)
        if signv <= 0:
            continue
        Vy = Vinv @ y
        V1 = Vinv @ ones
        VG = Vinv @ G[:, marker_idx]
        for mi, j in enumerate(marker_idx):
            g = G[:, j]
            XtVX = np.array([[ones @ V1, ones @ VG[:, mi]], [g @ V1, g @ VG[:, mi]]])
            sign, logdet_x = np.linalg.slogdet(XtVX)
            if sign <= 0:
                continue
            XtVy = np.array([ones @ Vy, g @ Vy])
            sol = np.linalg.solve(XtVX, XtVy)
            grid_vals[ti, mi] = 0.5 * logdet_v + (y @ Vy - XtVy @ sol) + logdet_x

    def pattern_search(f, x0, lo=-6.0, hi=0.0, step=0.5, n_scales=9):
        x = np.array(x0, np.float64)
        fx = f(x)
        for _ in range(n_scales):
            improved = True
            while improved:
                improved = False
                for d in ((step, 0), (-step, 0), (0, step), (0, -step)):
                    cand = np.clip(x + d, lo, hi)
                    fc = f(cand)
                    if fc < fx:
                        x, fx = cand, fc
                        improved = True
            step *= 0.5
        return x

    z_out = np.zeros(len(marker_idx))
    for mi, j in enumerate(marker_idx):
        Xf = np.stack([ones, G[:, j]], axis=1)
        x0 = np.log10(np.asarray(thetas[int(np.argmin(grid_vals[:, mi]))]))
        xopt = pattern_search(lambda x: _reml_neg_loglik(10.0 ** x, y, Xf, K), x0)
        th = 10.0 ** xopt
        V = th[1] * K + th[0] * np.eye(n)
        Vinv = np.linalg.pinv(V)
        cov_b = np.linalg.pinv(Xf.T @ Vinv @ Xf)
        b = cov_b @ (Xf.T @ Vinv @ y)
        z_out[mi] = b[-1] / np.sqrt(max(cov_b[-1, -1], 1e-30))
    return z_out


# --------------------------------------------------------------------------
# ledger
# --------------------------------------------------------------------------


def run_parity_ledger(
    emit: Callable[[str], None] = print,
    quick: bool = False,
    device="cuda",
) -> List[dict]:
    """Measure the port's models on `device` against their oracles; emit one
    JSON line per row and return the rows.

    `quick=True` runs only the closed-form rows (no samplers/REML). Every
    threshold is the JAX ledger's.
    """
    import genomicbreedingmodels_tpu_torch as gbm
    from .ops import linalg as L

    def grm64(genomes):
        return gbm.grm_simple(genomes, device=device).genomic_relationship_matrix.double().cpu().numpy()

    rows: List[dict] = []

    def push(r):
        rows.append(r)
        emit(json.dumps(r))

    # --- OLS: f64 lstsq oracle -------------------------------------------
    X, y = _sim_xy(n=80, p=60, seed=5)
    Xi = np.concatenate([np.ones((len(y), 1)), X], axis=1)
    b_o = np.linalg.lstsq(Xi, y, rcond=None)[0]
    b_d = L.lstsq_minnorm(Xi, y, device=device)
    push(_row("ols", "fitted-value correlation",
              _cor(Xi @ b_d, Xi @ b_o), 0.999,
              "f64 lstsq (LAPACK gels semantics, reference src/linear.jl:85)"))

    # --- ridge: closed-form oracle at the chosen λ ------------------------
    X, y = _sim_xy(n=80, p=120, seed=5)
    b0_d, beta_d, info = L.ridge_cv_path(X, y, n_lambda=25, n_folds=5, device=device)
    b0_o, beta_o = _ridge_oracle(X, y, info["lambdas"][info["chosen"]])
    push(_row("ridge", "GEBV correlation",
              _cor(b0_d + X @ beta_d, b0_o + X @ beta_o), 0.999,
              "f64 closed-form (Z'Z+nλI)⁻¹Z'y at the path-chosen λ (glmnet alpha=0 semantics)"))
    push(_row("ridge", "effect correlation", _cor(beta_d, beta_o), 0.999,
              "same closed form, marker effects"))

    # --- lasso: f64 coordinate-descent oracle at the chosen λ -------------
    X, y = _sim_xy(n=60, p=150, seed=9)
    b0_d, beta_d, info = L.lasso_cv_path(X, y, n_lambda=20, n_folds=5, screen_factor=0,
                                       device=device)
    mx = X.mean(axis=0)
    beta_o = _cd_lasso(X - mx, y - y.mean(), info["lambdas"][info["chosen"]])
    b0_o = y.mean() - mx @ beta_o
    push(_row("lasso", "GEBV correlation",
              _cor(b0_d + X @ beta_d, b0_o + X @ beta_o), 0.999,
              "f64 cyclic coordinate descent to 1e-10 (glmnet's algorithm) at the path-chosen λ"))

    # --- GBLUP: f64 closed-form mixed-model oracle at fitted components ---
    genomes = gbm.simulate_genomes(n=96, l=240, seed=11)
    trials, _ = gbm.simulate_trials(
        genomes, f_add_dom_epi=np.array([[0.5, 0.0, 0.0]]), seed=11
    )
    phenomes = gbm.extract_phenomes(trials)
    fit = gbm.gblup(genomes=genomes, phenomes=phenomes, device=device)
    Xg, yg, entries_g, pops_g, loci_g = gbm.extractxyetc(
        genomes, phenomes, add_intercept=False
    )
    yg = np.asarray(yg, np.float64)
    # Same GRM definition as the model (the GRM construction itself is
    # oracle-tested against f64 in tests/test_grm_ops.py); this row checks
    # the mixed-model SOLVE — dense f64 np.linalg.solve vs the library's
    # eigenbasis path — at the REML-fitted components.
    K = grm64(gbm.Genomes(entries=entries_g, populations=pops_g, loci_alleles=loci_g,
                          allele_frequencies=np.asarray(Xg, np.float64)))
    s_e, s_u = fit.extras["sigma2_e"], fit.extras["sigma2_u"]
    V = s_u * K + s_e * np.eye(len(yg))
    gebv_o = yg.mean() + s_u * K @ np.linalg.solve(V, yg - yg.mean())
    push(_row("gblup", "GEBV correlation", _cor(fit.y_pred, gebv_o), 0.999,
              "dense f64 mixed-model solve σ²_u·K(σ²_u·K+σ²_e·I)⁻¹y_c at the REML-fitted components (same GRM definition; solve independent of the eigenbasis path)"))

    if quick:
        return rows

    # --- BRR / BayesA / BL / BayesT: conjugate posterior (pinned) ---------
    # Pinned variances make EVERY continuous-prior chain exactly conjugate
    # Gaussian (s² is held at fix_b for all models — the prior families
    # differ only in how s² updates, which pinning removes), so one f64
    # closed form covers the whole continuous zoo.
    for model in ("BRR", "BayesA", "BL", "BayesT"):
        n, p = 60, 40
        X, y = _sim_xy(n=n, p=p, seed=13, k=10)
        sig_e2, sig_b2 = 0.5, 0.05
        b0_o, b_o = _conjugate_posterior_mean(X, y, sig_e2, sig_b2)
        mu_hat, b_hat, _ = gbm.gibbs_regression(
            X, y, model=model, n_iter=4200, n_burnin=200, seed=17,
            fix_sigma_e2=sig_e2, fix_sigma_b2=sig_b2, device=device,
        )
        push(_row(model.lower(), "GEBV correlation (pinned-variance conjugate mode)",
                  _cor(mu_hat + X @ b_hat, b0_o + X @ b_o), 0.999,
                  "exact Gaussian posterior mean (A⁻¹Z'y/σ²ₑ, A = Z'Z/σ²ₑ + I/σ²_b), f64"))

    # --- indicator zoo: long independent scalar-scan oracle chain ---------
    # The spike-slab posterior mean has no closed form; the oracle is the
    # one-marker-at-a-time scalar scan (bit-for-bit sequential Gibbs, the
    # kernel the grouped draw is equivalence-tested against) run as an
    # INDEPENDENT chain (different seed) on a strong-LD panel. Covers every
    # point-mass model: BayesB/C and the Turing-taxonomy BLπ/BayesTπ
    # (reference dead-code spec, src/bayes.jl:422-480, :745-855).
    rng = np.random.default_rng(0)
    n, p = 160, 384
    base = rng.normal(size=(n, p // 8))
    Xld = np.repeat(base, 8, axis=1) * 0.8 + 0.2 * rng.normal(size=(n, p))
    Xld = ((Xld - Xld.mean(0)) / (Xld.std(0) + 1e-8)).astype(np.float32)
    b_true = np.zeros(p)
    idx = rng.choice(p, 16, replace=False)
    b_true[idx] = rng.normal(size=16)
    yld = (Xld @ b_true + 0.5 * rng.normal(size=n)).astype(np.float32)
    for model in ("BayesC", "BayesB", "BLPi", "BayesTPi"):
        _, b_g, _ = gbm.gibbs_regression(
            Xld, yld, model=model, n_iter=600, n_burnin=200, seed=1,
            indicator_update="grouped", device=device,
        )
        _, b_s, _ = gbm.gibbs_regression(
            Xld, yld, model=model, n_iter=600, n_burnin=200, seed=2,
            indicator_update="scalar", device=device,
        )
        push(_row(model.lower(), "GEBV correlation (vs independent scalar-scan chain)",
                  _cor(Xld @ b_g, Xld @ b_s), 0.99,
                  "600-sweep one-marker-at-a-time sequential Gibbs, independent seed"))

    # --- multi-trait GBLUP: dense f64 Kronecker mixed-model solve ---------
    # At the EM-fitted (G_g, R) the BLUP has the closed form
    # u = (G_g⊗K) [(G_g⊗K) + R⊗I]⁻¹ vec(Y_c); the library never builds the
    # nt × nt system (it solves per-eigenvalue t×t problems in K's
    # eigenbasis + re-materializes marker effects), so the dense solve is an
    # independent check of the whole rotation path.
    genomes = gbm.simulate_genomes(n=64, l=200, seed=31)
    trials, _ = gbm.simulate_trials(
        genomes, f_add_dom_epi=np.array([[0.6, 0.0, 0.0], [0.4, 0.0, 0.0]]),
        seed=31,
    )
    phen_mt = gbm.extract_phenomes(trials)
    fits_mt = gbm.gblup_multitrait_cov(
        genomes=genomes, phenomes=phen_mt, missing_policy="complete-case", device=device
    )
    G_g = fits_mt[0].extras["genetic_covariance"]
    R_mt = fits_mt[0].extras["residual_covariance"]
    Y = np.asarray(phen_mt.phenotypes, np.float64)
    Kmt = grm64(genomes)
    nmt, tmt = Y.shape
    mu_mt = Y.mean(axis=0)
    Yc = (Y - mu_mt).T.reshape(-1)  # trait-major stacking
    Cg = np.kron(_psd64(G_g), Kmt)
    Vmt = Cg + np.kron(_psd64(R_mt), np.eye(nmt))
    u = (Cg @ np.linalg.solve(Vmt, Yc)).reshape(tmt, nmt)
    pred_lib = np.concatenate([f.y_pred for f in fits_mt])
    pred_o = np.concatenate([mu_mt[k] + u[k] for k in range(tmt)])
    push(_row("gblup-multitrait", "GEBV correlation (both traits)",
              _cor(pred_lib, pred_o), 0.999,
              "dense f64 Kronecker solve (G_g⊗K)[(G_g⊗K)+R⊗I]⁻¹vec(Y_c) at the EM-fitted components"))

    # --- gwasols: f64 per-marker pinv t-stats ----------------------------
    genomes = gbm.simulate_genomes(n=72, l=160, seed=23)
    trials, _ = gbm.simulate_trials(
        genomes, f_add_dom_epi=np.array([[0.6, 0.0, 0.0]]), n_qtl=5, seed=23
    )
    phen_g = gbm.extract_phenomes(trials)
    fit_go = gbm.gwasols(genomes=genomes, phenomes=phen_g, device=device)
    Gs, ys, Ks, _ = gbm.gwasprep(genomes, phen_g, device=device)
    Gs, ys, Ks = (np.asarray(a, np.float64) for a in (Gs, ys, Ks))
    pc1_o = _pc1_oracle(Ks)
    t_o = np.zeros(Gs.shape[1])
    for j in range(Gs.shape[1]):
        Xf = np.stack([np.ones(len(ys)), pc1_o, Gs[:, j]], axis=1)
        Vinv = np.linalg.pinv(Xf.T @ Xf)
        b = Vinv @ (Xf.T @ ys)
        t_o[j] = b[-1] / np.sqrt(max(Vinv[-1, -1], 1e-30))
    push(_row("gwasols", "t-stat correlation (all markers)",
              _cor(fit_go.b_hat, t_o), 0.999,
              "f64 per-marker pinv(XᵀX) t = b/√Vinv[end,end] with exact-eigh PC1 (reference src/gwas.jl:241-245)"))

    # --- gwaslmm: dense f64 GLS z at oracle-refit null components ---------
    fit_gl = gbm.gwaslmm(genomes=genomes, phenomes=phen_g, device=device)
    Ksym = 0.5 * (Ks + Ks.T)
    Xf0 = np.stack([np.ones(len(ys)), pc1_o], axis=1)
    lg0 = np.linspace(-5.0, 0.0, 12)
    cand = [(10.0 ** a, 10.0 ** b) for a in lg0 for b in lg0]
    vals = [_reml_neg_loglik(np.asarray(th), ys, Xf0, Ksym) for th in cand]
    x0 = np.log10(np.asarray(cand[int(np.argmin(vals))]))
    xo = _pattern_search_2d(
        lambda x: _reml_neg_loglik(10.0 ** x, ys, Xf0, Ksym), x0
    )
    th = 10.0 ** xo
    Vn = th[1] * Ksym + th[0] * np.eye(len(ys))
    Vninv = np.linalg.pinv(Vn)
    z_lib = np.asarray(fit_gl.b_hat, np.float64)
    top = np.argsort(-np.abs(z_lib))[:12]
    z_o = np.zeros(len(top))
    for mi, j in enumerate(top):
        Xf = np.stack([np.ones(len(ys)), pc1_o, Gs[:, j]], axis=1)
        cov_b = np.linalg.pinv(Xf.T @ Vninv @ Xf)
        b = cov_b @ (Xf.T @ Vninv @ ys)
        z_o[mi] = b[-1] / np.sqrt(max(cov_b[-1, -1], 1e-30))
    push(_row("gwaslmm", "z-stat correlation (top-12 markers)",
              _cor(z_lib[top], z_o), 0.999,
              "dense f64 GLS z at null-model components refit by f64 grid + pattern search (EMMAX design, divergence from the reference's singleton-(1|entries) model documented at models/gwas.py:15-32)"))

    # --- gwasreml: dense-pinv f64 oracle z-stats --------------------------
    genomes = gbm.simulate_genomes(n=48, l=96, seed=21)
    trials, _ = gbm.simulate_trials(
        genomes, f_add_dom_epi=np.array([[0.6, 0.0, 0.0]]), n_qtl=5, seed=21
    )
    phenomes = gbm.extract_phenomes(trials)
    fit = gbm.gwasreml(genomes=genomes, phenomes=phenomes, device=device)
    G, yv, Kz, _ = gbm.gwasprep(genomes, phenomes, device=device)
    G = np.asarray(G, np.float64)
    yv = np.asarray(yv, np.float64)
    Kz = np.asarray(Kz, np.float64)
    z_lib = np.asarray(fit.b_hat, np.float64)
    marker_idx = np.argsort(-np.abs(z_lib))[:12]
    z_o = _oracle_reml_z(yv, G, Kz, marker_idx)
    push(_row("gwasreml", "z-stat correlation (top-12 markers)",
              _cor(z_lib[marker_idx], z_o), 0.999,
              "dense-pinv f64 evaluation of the reference objective (src/gwas.jl:464-482), grid + pattern search, no eigen-rotation"))
    return rows
