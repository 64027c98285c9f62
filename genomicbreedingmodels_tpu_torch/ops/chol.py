"""Blocked Cholesky, blocked substitution and the GBLUP solve on a
lower-triangle-only Gram.

Port of genomicbreedingmodels_tpu/ops/chol.py.

- `blocked_cholesky`: the left-looking panel factorisation. Panel j's update
  is two products against all previous panels ((n - lo) x lo x b), the b x b
  diagonal block factors with `torch.linalg.cholesky_ex`, and the panel
  below it is formed as `Aij @ inv(Ljj)ᵀ`, the triangular inverse of the
  diagonal block taken once by `solve_triangular`.
- `blocked_cho_solve`: forward and backward substitution one panel at a time,
  a b x b product and one rank-b update per panel instead of 2n sequential
  steps.
- `gblup_solve_lower`: the GBLUP solve of the headline. Its default (nb=None)
  is `cholesky_ex` + `cholesky_solve` (cuSOLVER on the card); an integer `nb`
  runs `blocked_cho_solve`, as the JAX function always does.

Only the lower triangle of the matrix is read (diagonal blocks are mirrored
from their lower triangle), so Gram builders can skip the mirror pass. The
panel products are `torch.matmul` in float32; they match the JAX products
only with TF32 off, which is PyTorch's default. Nothing here syncs with the
host: a matrix that is not positive definite gives non-finite results, as in
the JAX version, because a failed factorisation is divided by zero.

Conditioning: the substitutions apply explicit inverses of the diagonal
blocks, which lose accuracy as κ(block)² where a triangular solve loses
κ(block). Meant for well-conditioned mixed-model systems (K + λI with λ well
above the noise floor); past κ ≈ 1e6 use the default path.

Spans (utils/logging.py, recorded inside a `tracing()` block):
`gblup_solve_lower` is `gbm.solve`; on its cuSOLVER path, inside it,
`gbm.solve.mirror` (the triangle mirrored, λ on the diagonal),
`gbm.solve.potrf` (`cholesky_ex`) and `gbm.solve.potrs` (`cholesky_solve`
and the GEBVs). The counter `gbm.solve.not_pd` counts, on the device, the
solves whose matrix was not positive definite (non-finite GEBVs).
"""

from __future__ import annotations

import torch

from ..device import as_tensor
from ..utils.logging import count, span, tracing_on

__all__ = ["blocked_cho_solve", "blocked_cholesky", "gblup_solve_lower"]


def _panels(A: torch.Tensor, nb: int) -> tuple[torch.Tensor, list[torch.Tensor], list[tuple[int, int]]]:
    """Left-looking blocked Cholesky of the lower triangle of `A`: (L, the
    inverse diagonal blocks, their (lo, hi) bounds). L's strict upper
    triangle is zero."""
    n = A.shape[0]
    b = -(-n // nb)
    L = torch.zeros_like(A)
    invs, bounds = [], []
    for lo in range(0, n, b):
        hi = min(lo + b, n)
        Ajj = torch.tril(A[lo:hi, lo:hi])
        Ajj = Ajj + torch.tril(Ajj, -1).T
        Aij = A[hi:, lo:hi]
        if lo:
            Lj = L[lo:hi, :lo]
            Ajj = Ajj - Lj @ Lj.T
            Aij = Aij - L[hi:, :lo] @ Lj.T
        Ljj, info = torch.linalg.cholesky_ex(Ajj)
        Ljj = Ljj / (info == 0)  # a failed block poisons every later panel and the solve
        inv = torch.linalg.solve_triangular(Ljj, torch.eye(hi - lo, dtype=A.dtype, device=A.device),
                                            upper=False)
        L[lo:hi, lo:hi] = Ljj
        L[hi:, lo:hi] = Aij @ inv.T
        invs.append(inv)
        bounds.append((lo, hi))
    return L, invs, bounds


def _solve_panels(L: torch.Tensor, invs: list[torch.Tensor], bounds: list[tuple[int, int]],
                  y: torch.Tensor) -> torch.Tensor:
    """x with L Lᵀ x = y, from `_panels`' representation."""
    z = y.clone()
    for (lo, hi), inv in zip(bounds, invs):  # forward: L z = y
        z[lo:hi] = inv @ z[lo:hi]
        z[hi:] -= L[hi:, lo:hi] @ z[lo:hi]
    x = z
    for (lo, hi), inv in zip(reversed(bounds), reversed(invs)):  # backward: Lᵀ x = z
        x[lo:hi] = inv.T @ (z[lo:hi] - L[hi:, lo:hi].T @ x[hi:])
    return x


def blocked_cholesky(A, nb: int = 16, device="cuda") -> torch.Tensor:
    """Lower Cholesky factor of (the lower triangle of) a positive definite
    matrix, float32, in about `nb` column panels; only A's lower triangle is
    read. See the module docstring for its conditioning caveat."""
    A = as_tensor(A, device, torch.float32)
    return _panels(A, int(nb))[0]


def blocked_cho_solve(A, y, nb: int = 16, device="cuda") -> torch.Tensor:
    """Solve A x = y for positive definite A (its lower triangle read) via
    `blocked_cholesky`'s panels, float32. Accuracy degrades on
    ill-conditioned A (the module docstring); ideal for K + λI systems."""
    A = as_tensor(A, device, torch.float32)
    return _solve_panels(*_panels(A, int(nb)), as_tensor(y, device, torch.float32))


def gblup_solve_lower(K_lower: torch.Tensor, y: torch.Tensor, lam: float,
                      nb: int | None = None) -> torch.Tensor:
    """GEBV from a lower-triangle-only centered Gram.

    Solves (K + lam I) alpha = y - mean(y) and returns K alpha + mean(y)
    (= yc - lam·alpha + mean(y): no n x n matvec). Only the lower triangle of
    `K_lower` is read, because `center_gram_lower` leaves nonzero values in
    the upper triangle. Runs where the tensors lie and does not sync with the
    host; a matrix that is not positive definite gives non-finite GEBVs (as
    the JAX version does) instead of an exception.

    `nb=None` mirrors the triangle and runs `cholesky_ex` + `cholesky_solve`
    (cuSOLVER on the card); an integer `nb` runs `blocked_cho_solve` with it,
    as the JAX function does with its default nb=16.
    """
    with span("gbm.solve", K_lower.device):
        n = K_lower.shape[0]
        mu = y.mean()
        yc = y - mu
        if nb is not None:
            A = K_lower.clone()
            A.diagonal().add_(lam)
            alpha = blocked_cho_solve(A, yc, nb=nb, device=K_lower.device)
            return yc - lam * alpha + mu
        with span("gbm.solve.mirror"):
            A = torch.tril(K_lower) + torch.tril(K_lower, -1).T
            A.diagonal().add_(lam)
        with span("gbm.solve.potrf"):
            L, info = torch.linalg.cholesky_ex(A)
        if tracing_on():
            count("gbm.solve.not_pd", info != 0)
        with span("gbm.solve.potrs"):
            alpha = torch.cholesky_solve(yc.reshape(n, 1), L).reshape(n) / (info == 0)
            return yc - lam * alpha + mu
