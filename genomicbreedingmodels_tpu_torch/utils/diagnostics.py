"""MCMC convergence diagnostics: split-R̂ and effective sample size.

Copied from genomicbreedingmodels_tpu/utils/diagnostics.py (numpy only). New
capability vs the reference (its BGLR subprocess returns point estimates
only, src/bayes.jl:94-99); implements the standard Gelman et al. split-R̂ and
Geyer initial-monotone-sequence ESS on host (the traces are tiny — one scalar
per sweep — so f64 numpy is the right tool).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["split_rhat", "ess", "mcmc_diagnostics"]


def _split_chains(chains: np.ndarray) -> np.ndarray:
    """(m, t) -> (2m, t//2): split each chain in half (drops an odd tail)."""
    chains = np.atleast_2d(np.asarray(chains, dtype=np.float64))
    t = chains.shape[1] // 2
    if t < 1:
        return chains
    return np.concatenate([chains[:, :t], chains[:, t : 2 * t]], axis=0)


def split_rhat(chains: np.ndarray) -> float:
    """Split-R̂ (potential scale reduction) over (m, t) scalar traces.

    < 1.01 excellent, < 1.05 acceptable; large values flag non-stationarity
    or disagreeing chains. Returns inf when variance degenerates.
    """
    c = _split_chains(chains)
    m, t = c.shape
    if t < 2:
        return np.inf
    chain_means = c.mean(axis=1)
    chain_vars = c.var(axis=1, ddof=1)
    W = chain_vars.mean()
    B = t * chain_means.var(ddof=1) if m > 1 else 0.0
    if W <= 1e-300:
        return np.inf if B > 0 else 1.0
    var_plus = (t - 1) / t * W + B / t
    return float(np.sqrt(var_plus / W))


def _autocov(x: np.ndarray) -> np.ndarray:
    """Biased autocovariance by FFT (what ESS estimators use)."""
    n = len(x)
    xc = x - x.mean()
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(xc, nfft)
    acov = np.fft.irfft(f * np.conj(f), nfft)[:n].real / n
    return acov


def ess(chains: np.ndarray) -> float:
    """Effective sample size via Geyer's initial monotone positive sequence,
    combining chains the rank-normalized-free classic way (BDA3 eq. 11.8)."""
    c = _split_chains(chains)
    m, t = c.shape
    if t < 4:
        return float(m * t)
    acovs = np.stack([_autocov(c[i]) for i in range(m)])
    W = np.mean([np.var(c[i], ddof=1) for i in range(m)])
    var_plus = (t - 1) / t * W + (t * np.var(c.mean(axis=1), ddof=1) if m > 1 else 0.0) / t
    if var_plus <= 1e-300:
        return float(m * t)
    rho = 1.0 - (W - acovs.mean(axis=0)) / var_plus  # (t,)
    # Geyer: sum consecutive pairs while positive, enforce monotone decrease.
    tau = 1.0
    prev_pair = np.inf
    for k in range(1, t - 1, 2):
        pair = rho[k] + rho[k + 1]
        if pair < 0:
            break
        pair = min(pair, prev_pair)
        prev_pair = pair
        tau += 2.0 * pair
    return float(max(m * t / max(tau, 1e-12), 1.0))


def mcmc_diagnostics(chains: np.ndarray, name: str = "sigma_e2") -> Dict[str, float]:
    """Diagnostics dict for (m, t) scalar traces; `converged` uses the
    conventional R̂ < 1.05 and ESS >= 100 thresholds."""
    chains = np.atleast_2d(np.asarray(chains, dtype=np.float64))
    r = split_rhat(chains)
    e = ess(chains)
    return {
        f"rhat_{name}": r,
        f"ess_{name}": e,
        "converged": bool(r < 1.05 and e >= 100.0),
    }
