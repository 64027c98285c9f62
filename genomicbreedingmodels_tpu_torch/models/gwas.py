"""REML in the GRM eigenbasis, torch port of the pieces of
genomicbreedingmodels_tpu/models/gwas.py that `gblup` uses: `_eigh_device`,
`_rotated_loglik`, `_reml_scan`, and the numpy reference objective
`loglikreml`. The GWAS scans themselves (`gwasols`, `gwaslmm`, `gwasreml`,
`gwasprep`) wait for the GWAS slice.

`jax.vmap` / `jax.grad` / `jax.hessian` become `torch.func.vmap` / `grad` /
`jacrev(jacrev(.))`; `lax.fori_loop` becomes a Python loop. The Hessian is
reverse-over-reverse on purpose: `torch.func.hessian` (forward-over-reverse)
gives wrong Hessians for all but the first marker under `vmap`, because
forward-mode AD of `slogdet` and `solve` is mis-batched there (torch 2.11 and
2.13). Everything runs in f32 where the inputs lie, with no host sync inside
the scan.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.func import grad, jacrev, vmap

__all__ = ["loglikreml"]

_EPS = 1e-6


def loglikreml(theta, data) -> float:
    """Reference REML objective (src/gwas.jl:450-483), for API parity/tests.

    theta = [σ²_e, σ²_u]; data = (y, X, K). Returns
    0.5 log|V| + yᵀPy + log|XᵀV⁻¹X| with V = σ²_u K + σ²_e I. Computed via
    the eigenbasis of the symmetrized K instead of a dense pinv (numpy f64,
    copied from the JAX package).
    """
    y, X, K = data
    s, U = np.linalg.eigh((np.asarray(K) + np.asarray(K).T) / 2.0)
    s = np.maximum(s, 0.0)
    yt = U.T @ y
    Xt = U.T @ X
    d = theta[1] * s + theta[0]
    XtVX = (Xt / d[:, None]).T @ Xt
    q = (Xt / d[:, None]).T @ yt
    yPy = float(np.sum(yt * yt / d) - q @ np.linalg.solve(XtVX, q))
    sign, logdet = np.linalg.slogdet(XtVX)
    if sign <= 0:
        return np.inf
    return float(0.5 * np.sum(np.log(d)) + yPy + logdet)


def _rotated_loglik(theta, yt, Xt, s):
    """Same objective on pre-rotated inputs; scalar tensor fn of θ = (σ²e, σ²u).

    yᵀPy is evaluated as rᵀV⁻¹r with r = yt − Xt·b_GLS (cancellation-free;
    see the JAX twin for the f32 failure the two-term form caused).
    """
    d = theta[1] * s + theta[0]
    inv_d = 1.0 / d
    XtVX = torch.einsum("nk,n,nm->km", Xt, inv_d, Xt)
    q = torch.einsum("nk,n,n->k", Xt, inv_d, yt)
    sol = torch.linalg.solve_ex(XtVX, q)[0]  # no raise, no sync on a singular XtVX
    r = yt - Xt @ sol
    yPy = torch.sum(r * r * inv_d)
    sign, logdet = torch.linalg.slogdet(XtVX)
    val = 0.5 * torch.sum(torch.log(d)) + yPy + logdet
    # Non-finite evaluations must rank as +inf: torch.argmin, like jnp.argmin,
    # returns a NaN when one is present, which would freeze Newton on garbage.
    return torch.where(torch.isfinite(val) & (sign > 0), val, math.inf)


def _reml_scan(yt: torch.Tensor, Xt_all: torch.Tensor, s: torch.Tensor,
               n_grid: int = 16, n_newton: int = 10):
    """Per-marker REML variance components + GLS z-stats, vmapped over markers.

    Xt_all: (p, n, k) rotated designs. Grid-seeds θ = (σ²e, σ²u) on a log
    lattice in [1e-5, 1]² (n_grid² points), then runs `n_newton` projected
    Newton steps in log-θ with a 3-way backtrack, clipped to [1e-6, 1]
    (the reference bounds, src/gwas.jl:588). Returns (z, theta) with
    z = b_k / sqrt(Var b_k).
    """
    grid = torch.logspace(-5, 0, n_grid, dtype=yt.dtype, device=yt.device)
    tg = torch.stack(torch.meshgrid(grid, grid, indexing="ij"), dim=-1).reshape(-1, 2)
    eye2 = 1e-4 * torch.eye(2, dtype=yt.dtype, device=yt.device)
    lo = math.log(_EPS)

    def solve_one(Xt):
        def ll_log(lt):
            return _rotated_loglik(torch.exp(lt), yt, Xt, s)

        vals = vmap(lambda th: _rotated_loglik(th, yt, Xt, s))(tg)
        lt = torch.log(tg[torch.argmin(vals)])
        for _ in range(n_newton):
            g = grad(ll_log)(lt)
            H = jacrev(jacrev(ll_log))(lt) + eye2
            step = torch.linalg.solve_ex(H, g)[0]
            f0 = ll_log(lt)
            cand = torch.stack([lt - step, lt - 0.5 * step, lt - 0.25 * step])
            fs = torch.stack([ll_log(c) for c in cand])
            best = torch.argmin(fs)
            lt_new = torch.where(fs[best] < f0, cand[best], lt)
            lt = torch.clamp(lt_new, lo, 0.0)
        theta = torch.exp(lt)
        d = theta[1] * s + theta[0]
        inv_d = 1.0 / d
        XtVX = torch.einsum("nk,n,nm->km", Xt, inv_d, Xt)
        q = torch.einsum("nk,n,n->k", Xt, inv_d, yt)
        cov_b = torch.linalg.pinv(XtVX)
        b = cov_b @ q
        z = b[-1] / torch.sqrt(torch.clamp(cov_b[-1, -1], min=1e-30))
        return z, theta

    return vmap(solve_one)(Xt_all)


def _eigh_device(K: torch.Tensor):
    """Eigendecomposition of 0.5(K + Kᵀ) where K lies (cuSOLVER on the card),
    eigenvalues clamped at 0."""
    s, U = torch.linalg.eigh(0.5 * (K + K.T))
    return torch.clamp(s, min=0.0), U
