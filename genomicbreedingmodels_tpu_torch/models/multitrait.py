"""Multi-trait GBLUP with a full genetic covariance, and multi-environment
GBLUP on trial records, torch port of
genomicbreedingmodels_tpu/models/multitrait.py (BASELINE config 5; the
reference has no multi-trait model and refits each trait alone,
src/cross_validation.jl:345-358).

Model: Y (n × t) with vec(U) ~ N(0, G_g ⊗ K) and vec(E) ~ N(0, R ⊗ I), G_g
and R the t×t genetic and residual covariances, K the n×n GRM. K = U S Uᵀ
is eigendecomposed once (`_eigh_device`: f64 on the card); in the rotated
basis the model decouples over the eigen-index i into t-dimensional problems
ỹᵢ ~ N(0, sᵢ G_g + R), so an EM-REML iteration costs O(n t³).

Where the work runs: the GRM (K1 or K2), its eigendecomposition, the
rotations (Uᵀ·, U·) and the n×p products (marker effects, fitted values) on
`device` in f64; the EM's per-eigen-index t×t algebra as batched f64 torch
on `device`, with the t×t covariance updates (`_psd_clip`) and the
missing-pattern bookkeeping of the imputation EM in f64 numpy on the host,
as in the JAX package.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.structs import Fit, Genomes, Phenomes, Trials
from ..device import as_tensor, resolve_device
from ..ops.metrics import metrics
from ..core.grm import grm_of_type
from ..ops.linalg import _eigh_device
from .gblup import _effects, _stage_clock, reml_variance_components

__all__ = ["mtgblup_em", "mtgblup_em_missing", "gblup_multitrait_cov", "gblup_multienv"]


def _psd_clip(A: np.ndarray, floor: float = 1e-10) -> np.ndarray:
    A = (A + A.T) / 2.0
    w, V = np.linalg.eigh(A)
    return (V * np.maximum(w, floor)) @ V.T


def _rel_change(new: np.ndarray, old: np.ndarray) -> float:
    return float(np.abs(new - old).max() / max(np.abs(old).max(), 1e-12))


def mtgblup_em(
    Yt,
    s,
    n_iter: int = 100,
    tol: float = 1e-8,
    init: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    R_extra: Optional[np.ndarray] = None,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[float]]:
    """EM-REML for the rotated multi-trait model ỹᵢ ~ N(0, sᵢ G_g + R).

    Yt: (n, t) rotated centred phenotypes (Uᵀ Y_c); s: (n,) GRM eigenvalues;
    numpy or tensors. Returns numpy (G_g, R, M, logliks), M (n, t) = E[ũ]
    the rotated BLUPs. `init=(G0, R0)` warm-starts the components (the
    missing-record outer loop); `R_extra` is a t×t total second-moment
    correction added to the residual update's numerator (the summed
    conditional covariances of imputed residuals, see `mtgblup_em_missing`).
    Each iteration's n batched t×t inverses and products run in f64 on
    `device`; its two t×t sums and the log-likelihood come back to the host
    in one read-back, where the updates are clipped to PSD.
    """
    dev = resolve_device(device)
    Yt = as_tensor(Yt, dev, torch.float64)
    s = as_tensor(s, dev, torch.float64)
    n, t = Yt.shape
    emp = (Yt.T @ Yt / n).cpu().numpy()
    if init is not None:
        G_g, R = _psd_clip(init[0]), _psd_clip(init[1])
    else:
        G_g = _psd_clip(0.5 * emp)
        R = _psd_clip(0.5 * emp)
    R_extra_tot = np.zeros((t, t)) if R_extra is None else np.asarray(R_extra)
    pos = s > 1e-10
    n_pos = int(pos.sum())
    w_pos = torch.where(pos, 1.0 / torch.where(pos, s, 1.0), 0.0)  # 1/sᵢ on s > 0
    logliks: List[float] = []
    M = torch.zeros_like(Yt)
    for _ in range(n_iter):
        sG = s[:, None, None] * as_tensor(G_g, dev, torch.float64)[None]  # (n, t, t) prior covs
        S = sG + as_tensor(R, dev, torch.float64)[None]
        W = torch.linalg.inv_ex(S)[0]
        logdet = torch.linalg.slogdet(S)[1]
        quad = torch.einsum("ni,nij,nj->n", Yt, W, Yt)
        C = sG @ W
        M = torch.einsum("nij,nj->ni", C, Yt)  # E[ũᵢ]
        V = sG - C @ sG  # posterior covariances
        E = Yt - M
        # Σᵢ (E[ũᵢ]E[ũᵢ]ᵀ + Vᵢ)/sᵢ over sᵢ > 0, Σᵢ (eᵢeᵢᵀ + Vᵢ) and the
        # log-likelihood (up to a constant), in one read-back
        G_sum = torch.einsum("n,ni,nj->ij", w_pos, M, M) + torch.einsum("n,nij->ij", w_pos, V)
        R_sum = E.T @ E + V.sum(dim=0)
        ll = -0.5 * (logdet + quad).sum()
        host = torch.cat([G_sum.reshape(-1), R_sum.reshape(-1), ll.reshape(1)]).cpu().numpy()
        logliks.append(float(host[-1]))
        G_sum, R_sum = host[: t * t].reshape(t, t), host[t * t : 2 * t * t].reshape(t, t)
        G_new = _psd_clip(G_sum / max(n_pos, 1))
        R_new = _psd_clip((R_sum + R_extra_tot) / n)
        delta = max(_rel_change(G_new, G_g), _rel_change(R_new, R))
        G_g, R = G_new, R_new
        if delta < tol:
            break
    return G_g, R, M.cpu().numpy(), logliks


def mtgblup_em_missing(
    Y: np.ndarray,
    s,
    U,
    n_outer: int = 40,
    n_inner: int = 5,
    tol: float = 1e-6,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, List[float]]:
    """Multi-trait EM-REML with per-(entry, trait) missing records.

    Y: (n, t) phenotypes with NaN marking missing cells (every row must
    observe at least one trait); s, U: the GRM eigendecomposition (numpy or
    tensors). Returns (G_g, R, M, mu, logliks), M the rotated BLUPs of the
    final inner EM and mu the per-trait fixed means.

    The imputation EM of the JAX package: alternate (1) the rotated EM
    (`mtgblup_em`, warm-started) on the completed panel, and (2) re-imputing
    each missing cell from its row's residual conditional, grouped by
    missing pattern π = (observed o, missing m): ê_m = R_mo R_oo⁻¹ e_o,
    y_m ← μ_m + u_m + ê_m with u = U M. The summed conditional covariances
    C_π = R_mm − R_mo R_oo⁻¹ R_om feed the next inner EM's R update
    (`R_extra`), so imputation noise is charged to R. The rotations Uᵀ(·)
    and U M run on `device`; the pattern loops on the host.
    """
    dev = resolve_device(device)
    Y = np.asarray(Y, dtype=np.float64)
    n, t = Y.shape
    O = np.isfinite(Y)
    if not np.all(O.sum(axis=1) >= 1):
        raise ValueError("every row must observe at least one trait")
    U = as_tensor(U, dev, torch.float64)
    s = as_tensor(s, dev, torch.float64)
    pats, pat_ids = np.unique(O, axis=0, return_inverse=True)
    pat_ids = pat_ids.reshape(-1)

    mu = np.array([Y[O[:, k], k].mean() for k in range(t)])
    Ycomp = np.where(O, Y, mu[None, :])  # start: per-trait observed means
    G_g = R = None
    logliks: List[float] = []
    M = np.zeros((n, t))
    for _ in range(n_outer):
        Yt = U.T @ as_tensor(Ycomp - mu, dev, torch.float64)
        R_extra = np.zeros((t, t))
        if G_g is not None:
            # total conditional covariance of the imputed residuals
            for pi, pat in enumerate(pats):
                m = np.flatnonzero(~pat)
                if len(m) == 0:
                    continue
                o = np.flatnonzero(pat)
                cnt = int(np.sum(pat_ids == pi))
                A = np.linalg.solve(R[np.ix_(o, o)], R[np.ix_(o, m)]).T
                R_extra[np.ix_(m, m)] += cnt * (R[np.ix_(m, m)] - A @ R[np.ix_(o, m)])
        init = None if G_g is None else (G_g, R)
        G_new, R_new, M, lls = mtgblup_em(Yt, s, n_iter=n_inner, init=init, R_extra=R_extra,
                                          device=dev)
        logliks.extend(lls)
        delta = np.inf if G_g is None else max(_rel_change(G_new, G_g), _rel_change(R_new, R))
        G_g, R = G_new, R_new
        # Re-impute: y_mis <- μ + u + R_mo R_oo⁻¹ (y_obs − μ − u)
        u = (U @ as_tensor(M, dev, torch.float64)).cpu().numpy()
        for pi, pat in enumerate(pats):
            m = np.flatnonzero(~pat)
            if len(m) == 0:
                continue
            o = np.flatnonzero(pat)
            rows = np.flatnonzero(pat_ids == pi)
            A = np.linalg.solve(R[np.ix_(o, o)], R[np.ix_(o, m)]).T
            e_obs = Y[np.ix_(rows, o)] - mu[o][None, :] - u[np.ix_(rows, o)]
            Ycomp[np.ix_(rows, m)] = mu[m][None, :] + u[np.ix_(rows, m)] + e_obs @ A.T
        # fixed means from the observed cells given the current genetic fit
        mu = np.array([(Y[O[:, k], k] - u[O[:, k], k]).mean() for k in range(t)])
        if delta < tol:
            break
    return G_g, R, M, mu, logliks


def gblup_multitrait_cov(
    genomes: Genomes,
    phenomes: Phenomes,
    idx_entries: Optional[Sequence[int]] = None,
    idx_loci_alleles: Optional[Sequence[int]] = None,
    GRM_type: str = "simple",
    n_iter: int = 100,
    missing_policy: str = "em",
    verbose: bool = False,
    device="cuda",
) -> List[Fit]:
    """Multi-trait GBLUP with full genetic and residual trait covariances.

    `missing_policy="em"` (default) keeps every entry with at least one
    observed trait and fills per-(entry, trait) gaps by the imputation EM
    of `mtgblup_em_missing`; `"complete-case"` drops every row with a
    missing trait. Per-trait metrics are on that trait's observed entries.

    Returns one Fit per trait with RR-BLUP-equivalent marker effects (so
    `predict` and the CV harness work unchanged); `extras` carry the shared
    G_g, R and genetic correlations, the trait's h², and the wall seconds
    of the stages grm, eigh, em and effects (`stage_seconds`).
    """
    if missing_policy not in ("em", "complete-case"):
        raise ValueError(f"unknown missing_policy {missing_policy!r}")
    if not genomes.checkdims():
        raise ValueError("the Genomes struct is corrupted")
    if not phenomes.checkdims():
        raise ValueError("the Phenomes struct is corrupted")
    if not np.array_equal(genomes.entries, phenomes.entries):
        raise ValueError("genomes and phenomes must be merged to have consistent entries")
    dev = resolve_device(device)
    stages, mark = _stage_clock(dev)
    idx_e = np.arange(genomes.n) if idx_entries is None else np.asarray(idx_entries, dtype=np.int64)
    idx_l = (np.arange(genomes.p) if idx_loci_alleles is None
             else np.asarray(idx_loci_alleles, dtype=np.int64))
    Y_all = np.asarray(phenomes.phenotypes[idx_e], dtype=np.float64)
    if missing_policy == "em":
        keep = np.flatnonzero(np.any(np.isfinite(Y_all), axis=1))
        if len(keep) < 2:
            raise ValueError("fewer than 2 entries with any multi-trait record")
    else:
        keep = np.flatnonzero(np.all(np.isfinite(Y_all), axis=1))
        if len(keep) < 2:
            raise ValueError("fewer than 2 entries with complete multi-trait records")
    rows = idx_e[keep]
    Y = Y_all[keep]
    if np.array_equal(rows, np.arange(genomes.n)) and np.array_equal(idx_l, np.arange(genomes.p)):
        X = genomes.allele_frequencies  # read only: no panel-sized host copy
    else:
        X = genomes.allele_frequencies[np.ix_(rows, idx_l)]
    if not np.all(np.isfinite(X)):
        raise ValueError(
            "the genotype panel contains missing/non-finite values; impute "
            "upstream or use prediction.mean_impute"
        )
    entries = genomes.entries[rows]
    populations = genomes.populations[rows]
    loci_alleles = genomes.loci_alleles[idx_l]
    n, t = Y.shape

    grm = grm_of_type(X, GRM_type, dev)
    K, denom = grm.genomic_relationship_matrix.double(), grm.denominator
    mark("grm")
    s, U = _eigh_device((K + K.T) / 2.0)
    mark("eigh")

    obs = np.isfinite(Y)
    if missing_policy == "em" and not np.all(obs):
        G_g, R, M, mu, logliks = mtgblup_em_missing(Y, s, U, n_outer=n_iter, device=dev)
    else:
        mu = Y.mean(axis=0)
        G_g, R, M, logliks = mtgblup_em(U.T @ as_tensor(Y - mu, dev, torch.float64), s,
                                        n_iter=n_iter, device=dev)
    mark("em")

    # Rotated BLUPs -> RR-BLUP-equivalent marker effects: u = U M and
    # Z Zᵀ = denom·K, so b_t = (1/denom) Zᵀ U (M_t / s) satisfies Z b_t = u_t
    # on the GRM's column space (zero-eigen directions have M -> 0).
    s_safe = torch.where(s > 1e-10, s, torch.inf)
    Xd = as_tensor(X, dev, torch.float64)
    B, xbar = _effects(Xd, U @ (as_tensor(M, dev, torch.float64) / s_safe[:, None]), denom)
    b0 = as_tensor(mu, dev, torch.float64) - xbar @ B
    Y_pred = (b0 + Xd @ B).cpu().numpy()
    B, b0 = B.cpu().numpy(), b0.cpu().numpy()
    del Xd
    mark("effects")

    kdiag = float(K.diagonal().mean())
    gvar = np.diag(G_g) * kdiag
    rvar = np.diag(R)
    d = np.sqrt(np.maximum(np.diag(G_g), 1e-30))
    gcor = G_g / np.outer(d, d)
    labels = np.concatenate([np.asarray(["intercept"], dtype=object), loci_alleles])

    fits: List[Fit] = []
    for k in range(t):
        ok = np.flatnonzero(obs[:, k])  # metrics on observed entries only
        y_true, y_pred = Y[ok, k], Y_pred[ok, k]
        fit = Fit(
            model="gblup",
            b_hat=np.concatenate([[b0[k]], B[:, k]]),
            b_hat_labels=labels,
            trait=str(phenomes.traits[k]),
            entries=entries[ok],
            populations=populations[ok],
            y_true=y_true,
            y_pred=y_pred,
            metrics=metrics(y_true, y_pred),
            extras={
                "engine": "multitrait-cov",
                "sigma2_u": float(G_g[k, k]),
                "sigma2_e": float(R[k, k]),
                "h2": float(gvar[k] / (gvar[k] + rvar[k])) if gvar[k] + rvar[k] > 0 else 0.0,
                "genetic_covariance": G_g,
                "residual_covariance": R,
                "genetic_correlations": gcor,
                "loglik": logliks[-1] if logliks else float("nan"),
                "stage_seconds": stages,
            },
        )
        if not fit.checkdims():
            raise RuntimeError("error fitting multitrait covariance gblup")
        fits.append(fit)
    return fits


def gblup_multienv(
    genomes: Genomes,
    trials: Trials,
    idx_trait: int = 0,
    GRM_type: str = "simple",
    n_rounds: int = 4,
    verbose: bool = False,
    device="cuda",
) -> Fit:
    """Multi-environment GBLUP on raw trial records.

    Model: y_r = μ + env_{e(r)} + u_{i(r)} + ε_r, env = year×season×site
    (random intercepts, σ²_env), u ~ N(0, σ²ᵤK). `n_rounds` alternations of
    two exact conditional steps: (1) the env BLUPs given u, shrunken
    env-mean residuals, with σ²_env from the posterior second moment;
    (2) the entry solve given env: env-corrected records collapsed to entry
    means and the eigenbasis GBLUP with REML variance components. The GRM,
    its eigendecomposition and the products with K and U run on `device`;
    the record bookkeeping on the host. Returns a `predict`-compatible Fit
    with the variance components and env effects in `extras`.
    """
    if not genomes.checkdims():
        raise ValueError("the Genomes struct is corrupted")
    dev = resolve_device(device)
    ent_index = {e: i for i, e in enumerate(genomes.entries.tolist())}
    rows_entry = np.asarray([ent_index[e] for e in trials.entries.tolist()], dtype=np.int64)
    env_keys = [
        f"{y}|{sn}|{st}" for y, sn, st in zip(
            trials.years.tolist(), trials.seasons.tolist(), trials.sites.tolist()
        )
    ]
    uniq_envs, env_ids = np.unique(env_keys, return_inverse=True)
    env_ids = env_ids.reshape(-1)
    n_env = len(uniq_envs)
    y_rec = np.asarray(trials.phenotypes[:, idx_trait], dtype=np.float64)
    ok = np.isfinite(y_rec)
    y_rec, rows_entry, env_ids = y_rec[ok], rows_entry[ok], env_ids[ok]
    n = genomes.n

    X = genomes.allele_frequencies
    if not np.all(np.isfinite(X)):
        raise ValueError(
            "the genotype panel contains missing/non-finite values; impute "
            "upstream or use prediction.mean_impute"
        )
    grm = grm_of_type(X, GRM_type, dev)
    K, denom = grm.genomic_relationship_matrix.double(), grm.denominator
    s, U = _eigh_device((K + K.T) / 2.0)

    mu = float(y_rec.mean())
    u_entry = np.zeros(n)
    m_e = np.bincount(env_ids, minlength=n_env).astype(np.float64)
    m_i = np.bincount(rows_entry, minlength=n).astype(np.float64)
    sigma2_env = max(float(np.var(
        np.bincount(env_ids, weights=y_rec, minlength=n_env) / np.maximum(m_e, 1.0), ddof=1
    )) if n_env > 1 else 0.0, 1e-8)
    sigma2_e = max(float(np.var(y_rec, ddof=1)) * 0.5, 1e-8)
    sigma2_u = sigma2_e

    for _ in range(n_rounds):
        # 1) env BLUP given the current u
        resid = y_rec - mu - u_entry[rows_entry]
        env_mean = np.bincount(env_ids, weights=resid, minlength=n_env) / np.maximum(m_e, 1.0)
        shrink = sigma2_env / (sigma2_env + sigma2_e / np.maximum(m_e, 1.0))
        env_eff = shrink * env_mean
        # EM-style update of σ²_env: the posterior second moment
        post_var = sigma2_env * (1.0 - shrink)
        sigma2_env = max(float(np.mean(env_eff**2 + post_var)), 1e-10)
        # 2) entry solve given env: collapse to per-entry means
        y_env_corr = y_rec - env_eff[env_ids]
        ybar = np.bincount(rows_entry, weights=y_env_corr, minlength=n) / np.maximum(m_i, 1.0)
        sigma2_e_bar_scale = float(np.mean(m_i[m_i > 0]))
        sigma2_e_mean, sigma2_u = reml_variance_components(ybar, K, eig=(s, U), device=dev)
        sigma2_e = max(sigma2_e_mean * sigma2_e_bar_scale, 1e-10)
        mu = float(ybar.mean())
        d = torch.clamp(sigma2_u * s + sigma2_e_mean, min=1e-12)
        alpha = U @ ((U.T @ as_tensor(ybar - mu, dev, torch.float64)) / d)
        u_entry = (sigma2_u * (K @ alpha)).cpu().numpy()

    Xd = as_tensor(X, dev, torch.float64)
    B, xbar = _effects(Xd, sigma2_u * alpha[:, None], denom)
    b0 = mu - float(xbar @ B[:, 0])
    y_pred = (b0 + Xd @ B[:, 0]).cpu().numpy()
    b = B[:, 0].cpu().numpy()
    del Xd
    kdiag = float(K.diagonal().mean())
    h2 = (
        sigma2_u * kdiag / (sigma2_u * kdiag + sigma2_e_mean)
        if sigma2_u + sigma2_e_mean > 0 else 0.0
    )
    fit = Fit(
        model="gblup",
        b_hat=np.concatenate([[b0], b]),
        b_hat_labels=np.concatenate(
            [np.asarray(["intercept"], dtype=object), genomes.loci_alleles]
        ),
        trait=str(trials.traits[idx_trait]),
        entries=genomes.entries,
        populations=genomes.populations,
        y_true=ybar,
        y_pred=y_pred,
        metrics=metrics(ybar, y_pred),
        extras={
            "engine": "multienv",
            "sigma2_u": float(sigma2_u),
            "sigma2_e": float(sigma2_e),
            "sigma2_env": float(sigma2_env),
            "h2": float(h2),
            "n_environments": int(n_env),
            "env_effects": {str(k): float(v) for k, v in zip(uniq_envs, env_eff)},
        },
    )
    if not fit.checkdims():
        raise RuntimeError("error fitting multi-environment gblup")
    return fit
