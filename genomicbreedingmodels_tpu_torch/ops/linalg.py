"""Linear-algebra ops of the model zoo, torch port of
genomicbreedingmodels_tpu/ops/linalg.py.

- `affine_predict`: the GEMV behind `predict` for every linear model.
- `lstsq_minnorm`: min-norm least squares (replaces LAPACK `X \\ y`,
  reference src/linear.jl:85). Wide panels solve the dual n×n system by one
  eigendecomposition; tall ones take an SVD. Both are min-norm on a
  rank-deficient X (`torch.linalg.lstsq` on CUDA has only the `gels` driver,
  which assumes full rank).
- `ridge_cv_path`: ridge over a λ path with k-fold CV (replaces glmnet with
  alpha=0, reference src/linear.jl:193-221). The raw Gram is one K2 launch on
  the bf16 panel (`ops/grm.gram_panel`); every fold's masked, centered Gram
  derives from it in O(n²), all folds are eigendecomposed in one batched
  `torch.linalg.eigh`, and the whole λ path comes from that basis.
- `lasso_cv_path`: pathwise FISTA with every λ as one batch of GEMMs
  (replaces glmnet coordinate descent with alpha=1, reference
  src/linear.jl:333-360); bulk iterations on bf16 operands with f32 products,
  then an f32 polish leg.

λ selection mirrors the reference: candidates sorted by CV mean loss, the
first whose coefficient variance exceeds 1e-10 wins. The intercept is
computed consistently with the chosen β (the reference's ridge indexes an
unsorted intercept path with sorted indices, src/linear.jl:214-219).

Products outside the Gram kernel are `torch` matmuls in float32; on the card
they must run without TF32, as PyTorch's default has them.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..device import as_tensor, resolve_device
from .grm import gram_panel

__all__ = [
    "affine_predict",
    "lstsq_minnorm",
    "ridge_cv_path",
    "lasso_cv_path",
    "make_lambda_grid",
    "make_fold_masks",
]

_F32_EPS = float(np.finfo(np.float32).eps)


def affine_predict(G, idx_e, idx_l, b0: float, b, device="cuda") -> np.ndarray:
    """ŷ = b0 + G[idx_e, idx_l] @ b as one f32 GEMV on `device` (f64 numpy out)."""
    sub = as_tensor(np.asarray(G)[np.ix_(idx_e, idx_l)], device, torch.float32)
    bt = as_tensor(b, device, torch.float32)
    out = torch.mv(sub, bt) + torch.tensor(b0, dtype=torch.float32, device=sub.device)
    return out.cpu().numpy().astype(np.float64)


def _eigh_device(K: torch.Tensor):
    """Eigendecomposition of 0.5(K + Kᵀ) where K lies (a batch of matrices
    too), eigenvalues clamped at 0, returned in K's dtype: the port's one
    eigh policy.

    On the card it runs in f64 (cuSOLVER): on an H100 the f32 spectra of
    162-183-entry fold GRMs lay up to 6.7e-4·max|K| from f64, the CPU's f32
    spectra 3.4e-6·max|K|, and the 162-entry fold's REML σ²ₑ, which lives on
    the small eigenvalues, moved by 25 % (`scripts/torch_gblup_fold_eigh.py`).
    On the CPU it runs in f32, as the JAX twin."""
    work = torch.float64 if K.device.type == "cuda" else torch.float32
    Kw = K.to(work)
    s, U = torch.linalg.eigh(0.5 * (Kw + Kw.mT))
    return torch.clamp(s, min=0.0).to(K.dtype), U.to(K.dtype)


# ---------------------------------------------------------------------------
# OLS (min-norm least squares)
# ---------------------------------------------------------------------------


def _lstsq_dual(X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    # b = Xᵀ (X Xᵀ)⁺ y — the minimum-norm solution for wide X. The n×n work
    # is f64 after the f32 Gram, its eigh through the port's one policy (f64
    # on the card, f32 on the CPU): at 256x2048 an f32 solve on the f64
    # basis still left validation y_pred ~1e-4·std(y) from an f64 lstsq.
    K = (X @ X.T).double()
    s, U = _eigh_device(K)
    tol = torch.clamp(s[-1], min=0.0) * K.shape[0] * _F32_EPS
    inv_s = torch.where(s > tol, 1.0 / s, torch.zeros_like(s))
    alpha = U @ (inv_s * (U.T @ y.double()))
    return X.T @ alpha.to(X.dtype)


def _lstsq_primal(X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    # The SVD min-norm solve of jnp.linalg.lstsq: singular values below
    # eps·max(n, p)·s_max are dropped.
    U, s, Vh = torch.linalg.svd(X, full_matrices=False)
    keep = s >= _F32_EPS * max(X.shape) * s[0]
    inv_s = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)), torch.zeros_like(s))
    return Vh.T @ (inv_s * (U.T @ y))


def lstsq_minnorm(X, y, device="cuda") -> np.ndarray:
    """Min-norm least-squares solution (replaces `X \\ y`, src/linear.jl:85).

    For underdetermined systems Julia's `\\` returns a pivoted-QR basic
    solution; both interpolate the training data identically, so fitted
    values and all downstream metrics agree.
    """
    X = as_tensor(X, device, torch.float32)
    y = as_tensor(y, device, torch.float32)
    n, p = X.shape
    b = _lstsq_dual(X, y) if p > n else _lstsq_primal(X, y)
    return b.cpu().numpy().astype(np.float64)


# ---------------------------------------------------------------------------
# Shared λ-path utilities
# ---------------------------------------------------------------------------


def make_lambda_grid(X, y, n_lambda: int = 100, lambda_min_ratio: float = 0.01, alpha: float = 1.0) -> np.ndarray:
    """glmnet-style log-spaced λ grid.

    λ_max = max_j |⟨x_j - x̄_j, y - ȳ⟩| / (n * max(alpha, 1e-3)); for ridge
    (alpha=0) glmnet uses the same 1e-3 floor. A tensor `X` takes one f32
    GEMV on its device; a host array the float64 numpy path of the JAX
    package, bit for bit.
    """
    n = X.shape[0]
    # ⟨x_j - x̄_j, y - ȳ⟩ = x_jᵀ(y - ȳ) since Σ(y - ȳ) = 0: no centered copy.
    if isinstance(X, torch.Tensor):
        yt = as_tensor(y, X.device, X.dtype)
        yc = yt - yt.mean()
        lam_max = float((yc @ X).abs().max())
    else:
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        yc = y - y.mean()
        lam_max = float(np.max(np.abs(yc @ X)))
    lam_max = max(lam_max / (n * max(alpha, 1e-3)), 1e-12)
    return np.logspace(np.log10(lam_max), np.log10(lam_max * lambda_min_ratio), n_lambda)


def make_fold_masks(n: int, n_folds: int, seed: int = 42) -> np.ndarray:
    """(k, n) float32 masks; mask[f, i] is 1 when row i is in TRAINING for fold f."""
    rng = np.random.default_rng(seed)
    fold_id = rng.permutation(n) % n_folds
    return np.stack([fold_id != f for f in range(n_folds)]).astype(np.float32)


def _path_defaults(n_lambda, lambda_min_ratio, n_folds):
    from ..utils.config import get_config

    cfg = get_config()
    return (cfg.n_lambda if n_lambda is None else n_lambda,
            cfg.lambda_min_ratio if lambda_min_ratio is None else lambda_min_ratio,
            cfg.path_cv_folds if n_folds is None else n_folds)


# ---------------------------------------------------------------------------
# Ridge: masked dual solves, whole λ path per fold from one eigenbasis
# ---------------------------------------------------------------------------


def _ridge_folds_fromgram(G, X, y, W, lambdas):
    """Validation squared-error sums of every fold at every λ, from the shared
    raw Gram G = X Xᵀ (no per-fold O(n²p) product).

    W (F, n) holds the {0, 1} training masks. Centering uses training-row
    means (glmnet fits an unpenalized intercept): with m the fold's column
    means and M = diag(w), the fold's masked centered Gram is
    M (G - X m 1ᵀ - 1 mᵀ Xᵀ + (m·m) 11ᵀ) M. The F masked Grams go through
    one batched eigh; every λ shares a fold's basis. Returns (se (F, L),
    validation counts (F,)).
    """
    n_tr = W.sum(1)
    mean_y = (W @ y) / n_tr
    mean_x = (W @ X) / n_tr[:, None]  # (F, p): O(Fnp), cheap against O(n²p)
    Xm = mean_x @ X.T  # (F, n): X m per fold
    mm = (mean_x * mean_x).sum(1)
    Gc = G[None] - Xm[:, :, None] - Xm[:, None, :] + mm[:, None, None]  # centered Grams
    yc = y[None] - mean_y[:, None]
    K = Gc * W[:, :, None] * W[:, None, :]
    # f32 on the card too, as `_ridge_full_eigh`: the λ shift damps the small
    # eigenpairs; in f64 the cv cell's y_pred moved by < 5e-7·std(y)
    # (scripts/torch_cv_fold_eigh.py).
    s, U = torch.linalg.eigh(K)
    s = torch.clamp(s, min=0.0)
    Ut_wy = torch.einsum("fij,fi->fj", U, W * yc)
    # gamma[f, :, l] = U diag(1/(s + n_tr λ_l)) Uᵀ (w yc)
    denom = s[:, :, None] + n_tr[:, None, None] * lambdas[None, None, :]
    gamma = U @ (Ut_wy[:, :, None] / denom)  # (F, n, L)
    # ŷ = mean_y + Z Zᵀ diag(w) gamma = Gc (w ⊙ gamma)
    preds = mean_y[:, None, None] + Gc @ (W[:, :, None] * gamma)
    val = 1.0 - W
    err = (y[None, :, None] - preds) ** 2 * val[:, :, None]
    return err.sum(1), val.sum(1)


def _ridge_full_eigh(X, y):
    """Full-data centered-Gram eigendecomposition (K2 on the bf16 panel),
    shared across all λ."""
    mean_y = y.mean()
    mean_x = X.mean(0)
    Z = X - mean_x[None, :]
    K = gram_panel(X.to(torch.bfloat16), device=X.device)  # P G P
    s, U = torch.linalg.eigh(K)
    return torch.clamp(s, min=0.0), U, U.T @ (y - mean_y), Z, mean_x, mean_y


def _ridge_beta_from_eigh(s, U, Ut_yc, Z, mean_x, mean_y, lam: float):
    """Ridge coefficients at one λ from the cached eigenbasis (O(n² + np))."""
    n = Z.shape[0]
    gamma = U @ (Ut_yc / (s + n * lam))
    beta = Z.T @ gamma
    return mean_y - mean_x @ beta, beta


def ridge_cv_path(
    X,
    y,
    n_lambda: int = None,
    lambda_min_ratio: float = None,
    n_folds: int = None,
    seed: int = 42,
    device="cuda",
) -> Tuple[float, np.ndarray, dict]:
    """k-fold CV over a ridge λ path; glmnetcv-equivalent selection.

    Path defaults (n_lambda=100, lambda_min_ratio=0.01, n_folds=10, the
    glmnet values the reference passes, src/linear.jl:193-203) come from
    GBMConfig (GBM_N_LAMBDA / GBM_LAMBDA_MIN_RATIO / GBM_PATH_CV_FOLDS).
    Returns (b0, beta, info) where info carries the λ grid, CV mean losses
    and the chosen index.
    """
    n_lambda, lambda_min_ratio, n_folds = _path_defaults(n_lambda, lambda_min_ratio, n_folds)
    dev = resolve_device(device)
    X = as_tensor(X, dev, torch.float32)
    y = as_tensor(y, dev, torch.float32)
    n = X.shape[0]
    n_folds = int(min(n_folds, n))
    lambdas = torch.tensor(make_lambda_grid(X, y, n_lambda, lambda_min_ratio, alpha=0.0),
                           dtype=torch.float32, device=dev)
    W = torch.from_numpy(make_fold_masks(n, n_folds, seed)).to(dev)
    # One O(n²p) Gram (K2, bf16 operands, f32 accumulation), then all folds
    # and all λ from it.
    G = gram_panel(X.to(torch.bfloat16), center=False, device=dev)
    se, nv = _ridge_folds_fromgram(G, X, y, W, lambdas)
    meanloss = se.sum(0).double().cpu().numpy() / max(float(nv.sum()), 1.0)
    order = np.argsort(meanloss, kind="stable")
    lambdas_np = lambdas.double().cpu().numpy()
    b0, beta, chosen = 0.0, np.zeros(X.shape[1]), int(order[0])
    eig = _ridge_full_eigh(X, y)
    for i in order:
        b0_i, beta_i = _ridge_beta_from_eigh(*eig, float(np.float32(lambdas_np[i])))
        beta_np = beta_i.double().cpu().numpy()
        if np.var(beta_np, ddof=1) > 1e-10 or i == order[-1]:
            b0, beta, chosen = float(b0_i), beta_np, int(i)
            break
    info = {"lambdas": lambdas_np, "meanloss": meanloss, "chosen": chosen}
    return b0, beta, info


# ---------------------------------------------------------------------------
# LASSO: batched pathwise FISTA over λ
# ---------------------------------------------------------------------------


def _mm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for bf16 operands with a float32 result, as the reference's
    `preferred_element_type=f32`: on the card one bf16 GEMM with an f32
    output (`torch.mm(..., out_dtype=)`); on the CPU the float32
    product of the bf16-rounded operands (each product of two bf16 numbers
    is exact in float32, so only the order of the f32 sums differs)."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _soft_threshold(x, t):
    return torch.sign(x) * torch.clamp(x.abs() - t, min=0.0)


def _momentum_schedule(n: int) -> list:
    """FISTA's (t_k - 1)/t_{k+1} for n steps from t = 1, in float32 as the
    reference's loop carries t."""
    out, tk = [], np.float32(1.0)
    for _ in range(n):
        tk_new = np.float32(0.5) * (np.float32(1.0) + np.sqrt(np.float32(1.0) + np.float32(4.0) * tk * tk))
        out.append(float((tk - np.float32(1.0)) / tk_new))
        tk = tk_new
    return out


def _lasso_fista_batch(Z, yc, w, lambdas, step, n_iter: int):
    """FISTA for (1/2n)‖M(yc - Z b)‖² + λ‖b‖₁, all λ in one batch.

    Z: (n, p) centered design; yc: (n,) centered response; w: (n,) row mask
    (all ones for the full-data path). Returns B: (p, L). The bulk
    iterations take the two GEMMs on bf16 operands with f32 products
    (`_mm_bf16`); the iterate and soft-threshold state stay f32. The last
    max(20, n_iter/8) iterations are an f32 polish leg (momentum restarted)
    so the iterates meet the KKT conditions to f32 precision rather than
    stalling at the bf16 gradient noise floor.
    """
    n_tr = w.sum()
    L = lambdas.shape[0]
    p = Z.shape[1]
    Zw32 = w[:, None] * Z
    ywc = (w * yc)[:, None]
    thr = step * lambdas[None, :]
    n_bulk = max(n_iter - max(20, n_iter // 8), 0)

    def leg(B, n_steps, low):
        Zlo = Zw32.to(torch.bfloat16) if low else Zw32
        ZloT = Zlo.T
        V = B
        for mom in _momentum_schedule(n_steps):
            if low:
                R = _mm_bf16(Zlo, V.to(torch.bfloat16)) - ywc
                grad = _mm_bf16(ZloT, R.to(torch.bfloat16)) / n_tr
            else:
                grad = (ZloT @ (Zlo @ V - ywc)) / n_tr
            B_new = _soft_threshold(V - step * grad, thr)
            V = B_new + mom * (B_new - B)
            B = B_new
        return B

    B = torch.zeros((p, L), dtype=torch.float32, device=Z.device)
    B = leg(B, n_bulk, low=True)
    return leg(B, n_iter - n_bulk, low=False)


def _ramp(n: int, dtype, device) -> torch.Tensor:
    """Unit-norm ramp from 1 to 2: the power iterations' start. Unlike
    ones/√n it has a generic component outside the null space of a
    column-centred Gram or of a column-standardised GRM's covariance."""
    v = torch.linspace(1.0, 2.0, n, dtype=dtype, device=device)
    return v / torch.linalg.norm(v)


def _power_iter_lmax(Zw):
    """Largest eigenvalue of ZᵀZ via 30 power iterations on the n×n Gram.

    The start is a ramp, not the reference's constant vector: Z is centered
    over the rows it weights, so 1 lies in K's null space, and the
    reference's iteration climbs out of it on float32 rounding alone (its
    estimate then depends on the platform's rounding: 226 against a top
    eigenvalue of 238 on a test panel, where the ramp gives 237.9)."""
    K = Zw @ Zw.T
    v = _ramp(K.shape[0], torch.float32, K.device)
    for _ in range(30):
        v = K @ v
        v = v / torch.clamp(torch.linalg.norm(v), min=1e-30)
    return v @ (K @ v)


def _sis_scores(X, y, w):
    """|Z_wᵀ (w yc)| marginal scores for sure-independence screening: one
    GEMV over the full panel."""
    mean_y = (w * y).sum() / w.sum()
    # ⟨x_j - x̄_j, w yc⟩ = x_jᵀ(w yc) - x̄_j Σ(w yc); Σ(w yc) = 0 by centering.
    return ((w * (y - mean_y)) @ X).abs()


def _lasso_fold_path(X, y, w, lambdas, n_iter, k_screen):
    """One fold's (or the full data's) λ path: screen, center, step, FISTA.
    Returns (B (k, L), Z, mean_x, mean_y, screened column indices or None)."""
    n_tr = w.sum()
    if k_screen < X.shape[1]:
        # jax.lax.top_k breaks ties by the lower index; so does a stable
        # descending sort (torch.topk promises no order among ties).
        idx = torch.sort(_sis_scores(X, y, w), descending=True, stable=True).indices[:k_screen]
        Xk = X.index_select(1, idx)
    else:
        idx, Xk = None, X
    mean_y = (w * y).sum() / n_tr
    mean_x = (w[:, None] * Xk).sum(0) / n_tr
    Z = Xk - mean_x[None, :]
    step = 1.0 / torch.clamp(_power_iter_lmax(w[:, None] * Z) / n_tr, min=1e-12)
    B = _lasso_fista_batch(Z, y - mean_y, w, lambdas, step, n_iter)
    return B, Z, mean_x, mean_y, idx


def lasso_cv_path(
    X,
    y,
    n_lambda: int = None,
    lambda_min_ratio: float = None,
    n_folds: int = None,
    seed: int = 42,
    n_iter: int = 400,
    screen_factor: int = 8,
    device="cuda",
) -> Tuple[float, np.ndarray, dict]:
    """k-fold CV over a LASSO λ path, batched FISTA; glmnetcv-style selection.

    For ultra-wide panels (p > screen_factor · n) each fold first applies
    sure-independence screening (the top screen_factor·n markers by marginal
    |Zᵀy|, one GEMV) and runs the path on the screened design: a LASSO
    solution has at most n_tr nonzero coefficients, so the screened set is a
    superset of the active set in all but adversarial LD structures, and the
    dense-FISTA work scales with n instead of p. Set screen_factor=0 to
    disable. Path defaults come from GBMConfig (see ridge_cv_path).
    """
    n_lambda, lambda_min_ratio, n_folds = _path_defaults(n_lambda, lambda_min_ratio, n_folds)
    dev = resolve_device(device)
    X = as_tensor(X, dev, torch.float32)
    y = as_tensor(y, dev, torch.float32)
    n, p = X.shape
    n_folds = int(min(n_folds, n))
    lambdas_np = make_lambda_grid(X, y, n_lambda, lambda_min_ratio, alpha=1.0)
    lambdas = torch.tensor(lambdas_np, dtype=torch.float32, device=dev)
    masks = torch.from_numpy(make_fold_masks(n, n_folds, seed)).to(dev)
    k_screen = p if screen_factor <= 0 else int(min(p, max(1024, screen_factor * n)))

    sums = np.zeros(n_lambda, dtype=np.float64)
    counts = 0.0
    for f in range(n_folds):
        w = masks[f]
        B, Z, _, mean_y, _ = _lasso_fold_path(X, y, w, lambdas, n_iter, k_screen)
        preds = mean_y + Z @ B
        val = 1.0 - w
        err = (y[:, None] - preds) ** 2 * val[:, None]
        sums += err.sum(0).double().cpu().numpy()
        counts += float(val.sum())
    meanloss = sums / max(counts, 1.0)

    # Full-data path at all λ (one batched FISTA), then reference-style pick.
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    B_full, _, mean_x, mean_y, idx_full = _lasso_fold_path(X, y, ones, lambdas, n_iter, k_screen)
    B_np = B_full.double().cpu().numpy()
    order = np.argsort(meanloss, kind="stable")
    # Degenerate fallback: if every λ gives var(β) ≤ 1e-10, take the best-CV
    # λ (order[0]); the reference leaves its Fit at the last loop index there
    # (src/linear.jl:352-360), an accident of its loop structure.
    chosen = int(order[0])
    for i in order:
        if np.var(B_np[:, i], ddof=1) > 1e-10:
            chosen = int(i)
            break
    beta_k = B_np[:, chosen]
    if idx_full is not None:
        beta = np.zeros(p)
        beta[idx_full.cpu().numpy()] = beta_k
    else:
        beta = beta_k
    b0 = float(mean_y) - float(mean_x.double().cpu().numpy() @ beta_k)
    info = {"lambdas": lambdas_np, "meanloss": meanloss, "chosen": chosen,
            "screened_to": k_screen if idx_full is not None else p}
    return b0, beta, info
