"""Plain reference of a GBLUP refit, and its lower-precision control.

A refit of an (n, p) panel X and phenotypes y: the centered GRM
K = P G P, P = I - 11ᵀ/n, of the raw Gram G = X Xᵀ (over ploidy² for
dosages), then GEBV = K (K + λI)⁻¹ (y - ȳ) + ȳ = yc - λ α + ȳ with
(K + λI) α = yc. Plain PyTorch in float64: the Gram over blocks of markers
(exact for int8 dosages and bf16 values), one Cholesky per panel and one
solve for every phenotype vector of that panel. Imports nothing of the
program.

The control computes the same in the precision next below the program's:
int8 panels keep their exact Gram, and the factor and the two triangular
solves take their block updates as TF32 products (the program factors and
solves in float32 with TF32 off); bf16 panels are rounded to float8 e4m3
under one scale (the program reads them in bf16).
"""

from __future__ import annotations

import torch

from .precision import fp8_round, tf32

BLOCK = 16_384  # marker columns per float64 product


def raw_gram(X: torch.Tensor, dtype=torch.float64, block: int = BLOCK) -> torch.Tensor:
    """X Xᵀ over blocks of columns, in `dtype`."""
    n, p = X.shape
    G = torch.zeros((n, n), dtype=dtype, device=X.device)
    for s in range(0, p, block):
        B = X[:, s:s + block].to(dtype)
        G.addmm_(B, B.T)
    return G


def centered_grm(X: torch.Tensor, ploidy: int | None, dtype=torch.float64) -> torch.Tensor:
    """P G P of the panel, G over ploidy² for int8 dosages."""
    G = raw_gram(X, dtype)
    if X.dtype == torch.int8:
        G /= float(ploidy * ploidy)
    rm = G.mean(dim=1)
    return G - rm[:, None] - rm[None, :] + rm.mean()


def gebv_from_factor(L: torch.Tensor, Y: torch.Tensor, lam: float, solve=None) -> torch.Tensor:
    """GEBVs of every row of Y (m, n) from the Cholesky factor of K + λI."""
    mu = Y.mean(dim=1, keepdim=True)
    Yc = Y - mu
    alpha = (solve or torch.cholesky_solve)(Yc.T.contiguous(), L).T
    return Yc - lam * alpha + mu


def gebv(X: torch.Tensor, Y: torch.Tensor, lam: float, ploidy: int | None) -> torch.Tensor:
    """Float64 GEBVs (m, n) of the m phenotype rows of Y on panel X."""
    A = centered_grm(X, ploidy)
    A.diagonal().add_(lam)
    L = torch.linalg.cholesky(A)
    del A
    return gebv_from_factor(L, Y.to(torch.float64), lam)


def cholesky_tf32(A: torch.Tensor, nb: int = 512) -> torch.Tensor:
    """Right-looking blocked Cholesky in float32 whose trailing updates are
    TF32 products: the factor the program's float32 potrf would give one
    precision lower."""
    A = A.to(torch.float32).clone()
    n = A.shape[0]
    with tf32():
        for k in range(0, n, nb):
            e = min(k + nb, n)
            Lkk = torch.linalg.cholesky(A[k:e, k:e])
            A[k:e, k:e] = Lkk
            if e < n:
                L21 = torch.linalg.solve_triangular(Lkk, A[e:, k:e].T, upper=False).T
                A[e:, k:e] = L21
                A[e:, e:] -= L21 @ L21.T
    return torch.tril(A)


def cholesky_solve_tf32(B: torch.Tensor, L: torch.Tensor, nb: int = 512) -> torch.Tensor:
    """(L Lᵀ)⁻¹ B by blocked forward and backward substitution in float32
    whose updates are TF32 products."""
    X = B.to(torch.float32).clone()
    n = L.shape[0]
    blocks = [(k, min(k + nb, n)) for k in range(0, n, nb)]
    with tf32():
        for k, e in blocks:  # L Z = B
            if k:
                X[k:e] -= L[k:e, :k] @ X[:k]
            X[k:e] = torch.linalg.solve_triangular(L[k:e, k:e], X[k:e], upper=False)
        for k, e in reversed(blocks):  # Lᵀ X = Z
            if e < n:
                X[k:e] -= L[e:, k:e].T @ X[e:]
            X[k:e] = torch.linalg.solve_triangular(L[k:e, k:e].T, X[k:e], upper=True)
    return X


def gebv_control(X: torch.Tensor, Y: torch.Tensor, lam: float, ploidy: int | None) -> torch.Tensor:
    """The control's GEBVs (m, n): the reference one precision below the
    program's (the module docstring)."""
    if X.dtype == torch.int8:
        A = centered_grm(X, ploidy, torch.float64).to(torch.float32)
        A.diagonal().add_(lam)
        L = cholesky_tf32(A)
    else:
        A = centered_grm(fp8_round(X.to(torch.float32)), None, torch.float64).to(torch.float32)
        A.diagonal().add_(lam)
        L = torch.linalg.cholesky(A)
    del A
    return gebv_from_factor(L, Y.to(torch.float32), lam, cholesky_solve_tf32).to(torch.float64)


def gap(program: torch.Tensor, reference: torch.Tensor) -> torch.Tensor:
    """Per refit (row): max |program - reference| over max |reference|."""
    program = program.to(reference.device, reference.dtype)
    return (program - reference).abs().amax(dim=1) / reference.abs().amax(dim=1)
