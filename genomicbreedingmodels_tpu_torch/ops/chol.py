"""GBLUP solve on a lower-triangle-only Gram.

Port of genomicbreedingmodels_tpu/ops/chol.py:gblup_solve_lower on
`torch.linalg.cholesky` + `torch.cholesky_solve` (cuSOLVER on the card). The
JAX package's `blocked_cholesky` / `blocked_cho_solve` exist to dodge XLA's
sequential triangular solves on the TPU and are not ported.
"""

from __future__ import annotations

import torch

__all__ = ["gblup_solve_lower"]


def gblup_solve_lower(K_lower: torch.Tensor, y: torch.Tensor, lam: float) -> torch.Tensor:
    """GEBV from a lower-triangle-only centered Gram.

    Solves (K + lam I) alpha = y - mean(y) and returns K alpha + mean(y)
    (= yc - lam·alpha + mean(y): no n x n matvec). Only the lower triangle of
    `K_lower` is read: it is mirrored before factoring, because
    `center_gram_lower` leaves nonzero values in the upper triangle. Runs
    where the tensors lie and does not sync with the host: the factorisation
    is `cholesky_ex`, so a matrix that is not positive definite gives
    non-finite GEBVs (as the JAX version does) instead of an exception.
    """
    n = K_lower.shape[0]
    mu = y.mean()
    yc = y - mu
    A = torch.tril(K_lower) + torch.tril(K_lower, -1).T
    A.diagonal().add_(lam)
    L, _ = torch.linalg.cholesky_ex(A)
    alpha = torch.cholesky_solve(yc.reshape(n, 1), L).reshape(n)
    return yc - lam * alpha + mu
