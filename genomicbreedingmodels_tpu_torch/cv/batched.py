"""Batched cross-validation engine, torch port of
genomicbreedingmodels_tpu/cv/batched.py for ridge, gblup and lasso: every
(trait, replication, fold, λ) of a model in a few device calls.

The reference's CV loop refits glmnet per fold in a Julia thread pool
(src/cross_validation.jl:159-185 + src/linear.jl:193). Ridge/RR-BLUP and
GBLUP folds share one Gram matrix:

1. K = Z Zᵀ of the centered panel is built ONCE, by K2 in float32
   (`gram_tri_float`, 3xTF32 on the card; the lower triangle, mirrored).
2. A fold is a {0,1} training mask w. The masked Gram (w wᵀ) ⊙ K has zero
   rows and columns on held-out entries, so its eigendecomposition gives the
   fold's exact training-only dual solve with no gather or scatter.
3. All folds' masked Grams go through one batched `torch.linalg.eigh`, and
   the whole λ path comes from each fold's basis. Per-fold λ selection never
   touches validation rows:
   - ridge: training-only GCV (glmnet-equivalent selection inside the
     training set);
   - gblup: the REML profile criterion over a variance-ratio grid — GBLUP
     IS ridge with the REML-chosen ratio, so this is the batched analogue of
     models/gblup.py;
   - lasso: pathwise FISTA per fold (ops/linalg.py) with training GCV using
     the active-set size as degrees of freedom.

4. The Bayesian zoo (all eight priors) runs as F row-masked Gibbs chains
   per (trait, model), one chain with a fold axis
   (models/bayesian.py:gibbs_cv_folds): on the card the indicator models
   launch K3 once per block and sweep for all F folds.

Fold-label RNG matches `cvbulk` (uniform with replacement, seeded), so the
fold composition of the two engines is identical for a given seed.

Spans (utils/logging.py, recorded inside a `tracing()` block): a call is
`gbm.cv`; its `LAST_TIMER` stages are `gbm.cv.<stage>`; inside them
`gbm.cv.eigh` (the folds' batched eigh), `gbm.cv.path` (the λ path and its
criterion), `gbm.cv.readback` (each read-back of a fold batch) and, per
lasso fold, `gbm.cv.lasso.fold` with `gbm.cv.lasso.power_iter` and
`gbm.cv.lasso.fista` inside it.

`mesh=` (parallel/mesh.py; every rank calls with the same arguments) spreads
each fold batch over the mesh's largest axis (the first on a tie), as the
JAX `_solve_folds_meshed` / `_lasso_folds_meshed` do: every rank builds the
Gram on its device, solves its contiguous share of the folds (dummy
all-training folds pad F to a multiple of the axis size), and the folds'
results are gathered, so every rank emits every CV.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.structs import CV, Fit, Genomes, Phenomes
from ..device import as_tensor, resolve_device
from ..kernels.gram_tri import gram_tri_float
from ..models.bayesian import gibbs_cv_folds
from ..ops import linalg
from ..ops.metrics import metrics
from ..parallel.mesh import fold_share
from ..utils.devcache import SingleSlotCache, host_fingerprint
from ..utils.logging import StageTimer, span
from .harness import _common_checks

# Stage timing of the most recent cvbulk_batched call.
LAST_TIMER: Optional[StageTimer] = None
# Device panel, centered panel and Gram of the most recent host panel and
# device (utils/devcache.py).
_PANEL_CACHE = SingleSlotCache()

__all__ = ["cvbulk_batched"]

BATCHED_MODELS = (
    "ridge", "gblup", "lasso",
    # The Bayesian zoo: F row-masked Gibbs chains per (trait, model), one
    # chain with a fold axis (models/bayesian.py:gibbs_cv_folds).
    "bayesa", "bayesb", "bayesc", "bayesian_ridge", "bayesian_lasso",
    "bayesian_lasso_pi", "bayest", "bayestpi",
)

_GIBBS_MODEL_KEYS = {
    "bayesa": "BayesA",
    "bayesb": "BayesB",
    "bayesc": "BayesC",
    "bayesian_ridge": "BRR",
    "bayesian_lasso": "BL",
    "bayesian_lasso_pi": "BLPi",
    "bayest": "BayesT",
    "bayestpi": "BayesTPi",
}


def _gram(X: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K = Z Zᵀ, Z) of the column-centered panel Z, K by K2 in float32."""
    Z = (X - X.mean(0, keepdim=True)).contiguous()
    L = gram_tri_float(Z)
    return L + torch.tril(L, -1).T, Z


def _masked_eigh(K, y, W):
    """Per fold: the training mean of y, the masked centered response, and the
    eigendecomposition of the masked Gram, all folds in one batched eigh."""
    # Each fold's arithmetic is independent of how many folds are batched
    # (a fold share of a mesh rank gives mesh=None's bits): row sums and row
    # vectors times matrices, not W·y or a batched matrix times a column,
    # which the host rounds differently for different F.
    with span("gbm.cv.eigh"):
        n_w = W.sum(1)
        mean_y = (W * y).sum(1) / n_w
        yc = (y[None] - mean_y[:, None]) * W
        # f32 on the card too, unlike `_eigh_device`: the ridge shift and gblup's
        # smallest ratio damp the small eigenpairs, and at the cv cell (15 x
        # 2048²) f64 moved validation y_pred by < 2e-6·std(y)
        # (scripts/torch_cv_fold_eigh.py).
        s, U = torch.linalg.eigh(K[None] * W[:, :, None] * W[:, None, :])
        s = torch.clamp(s, min=0.0)
        return n_w, mean_y, s, U, (yc[:, None, :] @ U)[:, 0]


def _fold_path(K, W, U, Ut_y, mean_y, d):
    """Every fold's predictions and dual coefficients along the grid, given
    its eigenbasis and the shifted spectra d (F, L, n): gamma = w ⊙ U
    diag(1/d) Uᵀ yc (zero-eigenvalue held-out coordinates carry yc = 0
    anyway), pred = mean_y + K gamma. Returns (preds, gammas), (F, L, n)."""
    gamma = torch.einsum("fij,flj->fli", U, Ut_y[:, None, :] / d) * W[:, None, :]
    return mean_y[:, None, None] + gamma @ K, gamma


def _sharded(fn, mesh, W):
    """`fn(W)` over all folds of W; with a mesh of several ranks, over this
    rank's share of them (all-training dummies pad the batch), each output
    (numpy or tensor) gathered from every rank."""
    if mesh is None or mesh.size == 1:
        return fn(W)
    F = W.shape[0]
    axis, Fp, lo, hi = fold_share(mesh, F)
    W = torch.cat([W, torch.ones((Fp - F, W.shape[1]), dtype=W.dtype, device=W.device)])
    outs = []
    for o in fn(W[lo:hi]):
        t = mesh.allgather(torch.from_numpy(o) if isinstance(o, np.ndarray) else o, axis)[:F]
        outs.append(t.numpy() if isinstance(o, np.ndarray) else t)
    return tuple(outs)


def _solve_folds(K, y, W, grid, kind: str):
    """All folds of one ridge or gblup sweep: preds (F, L, n) and crit (F, L)
    as numpy (the device solve and its read-back), gammas (F, L, n) on the
    device.

    ridge: λ chosen by training-only GCV, MSE_train / (1 - edf/n_w)², NEVER
    the validation rows (the reference's glmnet likewise selects λ inside the
    training set).

    gblup: the variance ratio r chosen by the REML profile criterion. The
    masked Gram's spectrum is {training-submatrix spectrum} ∪ {0 per
    validation row}; eigenpairs are weighted by their training support
    ωᵢ = Σⱼ wⱼ U²ⱼᵢ ∈ {0, 1}, so the log-det term counts only training
    dimensions: crit(r) = Σᵢ ωᵢ log(sᵢ + r) + (Σω) log Σᵢ ỹᵢ²/(sᵢ + r).
    """
    n_w, mean_y, s, U, Ut_y = _masked_eigh(K, y, W)
    with span("gbm.cv.path"):
        if kind == "ridge":
            d = s[:, None, :] + grid[None, :, None] * n_w[:, None, None]
        else:
            d = s[:, None, :] + grid[None, :, None]
        preds, gammas = _fold_path(K, W, U, Ut_y, mean_y, d)
        if kind == "ridge":
            edf = (s[:, None, :] / d).sum(-1)
            res_tr = (((y[None, None, :] - preds) * W[:, None, :]) ** 2).sum(-1)
            crit = (res_tr / n_w[:, None]) / torch.clamp((1.0 - edf / n_w[:, None]) ** 2, min=1e-6)
        else:
            wU = (W[:, None, :] @ (U * U))[:, 0]  # per-eigenpair training support
            quad = torch.clamp((Ut_y[:, None, :] ** 2 / d).sum(-1), min=1e-30)
            crit = ((wU[:, None, :] * torch.log(torch.clamp(d, min=1e-30))).sum(-1)
                    + wU.sum(-1)[:, None] * torch.log(quad))
    with span("gbm.cv.readback"):
        return (preds.cpu().numpy(), gammas, crit.cpu().numpy())


def _lambda_max_device(X, y, w):
    """max_j |⟨x_j − x̄_j, y − ȳ⟩| over rows with w=1, plus the row count."""
    n_f = w.sum()
    mean_y = (w * y).sum() / torch.clamp(n_f, min=1.0)
    ywc = w * (y - mean_y)  # Σ ywc = 0 ⇒ the x̄_j term vanishes
    return float((ywc @ X).abs().max()), float(n_f)


def _lasso_fold(X, y, w, lambdas, n_iter: int = 300):
    """One LASSO fold: batched pathwise FISTA (ops/linalg.py) on the fold's
    training rows; GCV with active-set df for training-only λ selection.

    Returns (preds (L, n), B (p, L), crit (L,), b0 (L,))."""
    with span("gbm.cv.lasso.fold"):
        n_tr = w.sum()
        mean_y = (w * y).sum() / n_tr
        mean_x = (w[:, None] * X).sum(0) / n_tr
        Z = X - mean_x[None, :]
        with span("gbm.cv.lasso.power_iter"):
            step = 1.0 / torch.clamp(linalg._power_iter_lmax(w[:, None] * Z) / n_tr, min=1e-12)
        with span("gbm.cv.lasso.fista"):
            B = linalg._lasso_fista_batch(Z, y - mean_y, w, lambdas, step, n_iter)  # (p, L)
        preds = mean_y + Z @ B  # (n, L)
        mse = (((y[:, None] - preds) * w[:, None]) ** 2).sum(0) / n_tr
        df = (B.abs() > 1e-8).sum(0).to(torch.float32)
        gcv = mse / torch.clamp((1.0 - torch.minimum(df, n_tr - 1.0) / n_tr) ** 2, min=1e-6)
        b0 = mean_y - mean_x @ B
        return preds.T, B, gcv, b0


def _lasso_folds(X, y, W, lambdas):
    """The lasso fold batch, one fold after another (each fold's FISTA is
    already a batch of GEMMs over λ; a fold-batched one would hold F
    centered copies of the panel). Returns numpy (preds (F, L, n),
    B (F, p, L), crit (F, L), b0 (F, L))."""
    outs = [_lasso_fold(X, y, W[f], lambdas) for f in range(W.shape[0])]
    with span("gbm.cv.readback"):
        return tuple(torch.stack(o).cpu().numpy() for o in zip(*outs))


def cvbulk_batched(
    genomes: Genomes,
    phenomes: Phenomes,
    models: Sequence[str] = ("ridge",),
    n_replications: int = 5,
    n_folds: int = 5,
    seed: int = 42,
    lambdas: Optional[Sequence[float]] = None,
    store_effects: bool = True,
    mesh=None,
    mcmc_n_iter: Optional[int] = None,
    mcmc_n_burnin: Optional[int] = None,
    verbose: bool = False,
    device="cuda",
) -> Tuple[List[CV], List[str]]:
    """Replicated k-fold CV, batched on `device`.

    `models` ⊆ BATCHED_MODELS: ridge, gblup, lasso and the eight Bayesian
    models, which run as row-masked Gibbs chains with a fold axis, one chain
    per (trait, model) covering every (replication, fold)
    (`mcmc_n_iter`/`mcmc_n_burnin` override the config chain length).
    With `mesh`, the folds are spread over the ranks (see the module
    docstring) on each rank's mesh device. Returns the same (cvs, notes)
    surface as `cvbulk`; each CV's fit carries the fold's chosen λ (or
    variance ratio) in `extras` (`engine` "batched-gibbs" for the chains)
    and, with `store_effects`, marker effects in `b_hat`, so `predict` works.
    """
    for m in models:
        if m not in BATCHED_MODELS:
            raise ValueError(
                f"{m!r} is not a batched CV model; choose from {BATCHED_MODELS} "
                "(use cvbulk for the full model zoo)"
            )
    dev = resolve_device(device) if mesh is None else mesh.device
    _common_checks(genomes, phenomes, ["ridge"])
    n, p = genomes.allele_frequencies.shape
    if not (1 <= n_folds <= n):
        raise ValueError(f"n_folds={n_folds} out of bounds (1..{n})")
    if not (1 <= n_replications <= 100):
        raise ValueError(f"n_replications={n_replications} out of bounds (1..100)")
    if lambdas is None:
        lambdas = np.logspace(-4, 1, 12)
    lambdas = np.asarray(lambdas, dtype=np.float64)  # reported as given; solved in float32

    global LAST_TIMER
    with span("gbm.cv", dev):
        timer = LAST_TIMER = StageTimer(span_prefix="gbm.cv.")

        with timer.stage("h2d+gram"):
            # Device panel + Gram cached across calls on the same host panel and
            # device (single slot, fingerprint-keyed).
            key = (host_fingerprint(genomes.allele_frequencies), str(dev))
            hit = _PANEL_CACHE.get(key)
            if hit is None:
                X = as_tensor(genomes.allele_frequencies, dev, torch.float32)
                K, Z = _gram(X)
                tr_scale = float(K.diagonal().sum()) / n  # gblup ratio grid scale (a read-back)
                hit = _PANEL_CACHE.put(key, (X, K, Z, tr_scale))
            X, K, Z, tr_scale = hit

        cvs: List[CV] = []
        notes: List[str] = []
        rng = np.random.default_rng(seed)  # one stream: fold labels match cvbulk

        for idx_trait, trait in enumerate(phenomes.traits.tolist()):
            phi = np.asarray(phenomes.phenotypes[:, idx_trait], dtype=np.float64)
            finite = np.isfinite(phi)
            # ALL (replication, fold) masks of this trait up front: the sweep is
            # then F = reps × folds problems in one batch.
            w_list, v_list, tags = [], [], []
            for i in range(1, n_replications + 1):
                fold_labels = rng.integers(1, n_folds + 1, size=n)
                for j in range(1, n_folds + 1):
                    tr_mask = (fold_labels != j) & finite
                    va_mask = (fold_labels == j) & finite
                    if tr_mask.sum() < 2 or va_mask.sum() < 1:
                        notes.append(";".join(["too_many_missing", trait, f"replication_{i}", f"fold_{j}"]))
                        continue
                    if np.var(phi[tr_mask], ddof=1) < 1e-20:
                        notes.append(";".join(["zero_variance", trait, f"replication_{i}", f"fold_{j}"]))
                        continue
                    w_list.append(tr_mask.astype(np.float32))
                    v_list.append(va_mask.astype(np.float32))
                    tags.append((f"replication_{i}", f"fold_{j}"))
            if not w_list:
                continue
            cvs.extend(
                _run_models_on_masks(
                    genomes, phi, str(trait), np.stack(w_list), np.stack(v_list), tags, models,
                    X=X, K=K, Z=Z, lambdas=lambdas, tr_scale=tr_scale,
                    store_effects=store_effects, seed=seed, mcmc_n_iter=mcmc_n_iter,
                    mcmc_n_burnin=mcmc_n_burnin, timer=timer, mesh=mesh,
                )
            )
        return cvs, notes


def _run_models_on_masks(
    genomes, phi, trait, W, V, tags, models, *, X, K, Z, lambdas, tr_scale, store_effects,
    seed=42, mcmc_n_iter=None, mcmc_n_burnin=None, timer=None, mesh=None,
) -> List[CV]:
    """Run every model over one batch of (train, val) mask pairs.

    A "fold" is ANY {0,1} training/validation mask pair, so the same
    masked-Gram / FISTA machinery serves replicated k-fold and population
    sweeps. `tags` carries the (replication, fold) strings verbatim into the
    CV structs. `mesh` spreads the folds over its ranks (`_sharded`).
    """
    dev = K.device
    finite = np.isfinite(phi)
    y = as_tensor(np.where(finite, phi, 0.0), dev, torch.float32)
    Wt = as_tensor(W, dev, torch.float32)
    cvs: List[CV] = []
    timer = timer if timer is not None else StageTimer(span_prefix="gbm.cv.")
    x_mean = genomes.allele_frequencies.mean(axis=0) if store_effects else None
    for model in models:
        if model in _GIBBS_MODEL_KEYS:
            with timer.stage(f"{model}_solve"):
                mus, betas = gibbs_cv_folds(
                    X, y, W, model=_GIBBS_MODEL_KEYS[model], n_iter=mcmc_n_iter,
                    n_burnin=mcmc_n_burnin, seed=seed, mesh=mesh, device=dev,
                )
            with timer.stage(f"{model}_emit"):
                # (n, F): column f is fold f's prediction for every entry
                preds_g = mus[None, :] + np.asarray(genomes.allele_frequencies,
                                                    dtype=np.float64) @ betas.T
                for f, (rep, fold) in enumerate(tags):
                    cvs.append(
                        _emit_gibbs(genomes, phi, W[f], V[f], preds_g[:, f], float(mus[f]),
                                    betas[f], model, trait, rep, fold, store_effects)
                    )
        elif model in ("ridge", "gblup"):
            # ridge: λ as given; gblup: variance ratios on the Gram's trace scale
            grid_np = lambdas if model == "ridge" else tr_scale * np.logspace(-3.0, 3.0, 13)
            grid = torch.tensor(grid_np, dtype=torch.float32, device=dev)
            if model == "gblup":  # reported as solved, as the JAX package does
                grid_np = grid.double().cpu().numpy()
            # _solve_folds returns numpy, so the stage holds the device solve
            # AND its read-back.
            with timer.stage(f"{model}_solve"):
                preds, gammas, crit = _sharded(
                    lambda Wf: _solve_folds(K, y, Wf, grid, model), mesh, Wt)
            with timer.stage(f"{model}_emit"):
                best = np.argmin(crit, axis=1)
                betas = None
                if store_effects:  # β_f = Zᵀ(w_f ⊙ γ_f): one GEMM for every fold
                    g_best = gammas[torch.arange(len(best), device=dev), torch.as_tensor(best, device=dev)]
                    betas = (Z.T @ g_best.T).T.double().cpu().numpy()
                for f, (rep, fold) in enumerate(tags):
                    cvs.append(
                        _emit_dual(
                            genomes, phi, W[f], V[f], preds[f, best[f]],
                            None if betas is None else betas[f], x_mean, model, trait, rep, fold,
                            float(grid_np[best[f]]), store_effects,
                        )
                    )
        else:  # lasso
            # glmnet-style λ grid on the device-resident panel: λ_max over
            # the finite rows (the semantics of ops.linalg.make_lambda_grid).
            with timer.stage("lasso_grid"):
                lam_max, n_f = _lambda_max_device(X, y, as_tensor(finite.astype(np.float32), dev))
                lm = max(lam_max / max(n_f, 1.0), 1e-12)
                lasso_np = np.logspace(np.log10(lm), np.log10(lm * 0.01), 16).astype(np.float32)
                lasso_lams = torch.tensor(lasso_np, device=dev)
            with timer.stage("lasso_solve"):
                preds_l, B_l, crit_l, b0_l = _sharded(
                    lambda Wf: _lasso_folds(X, y, Wf, lasso_lams), mesh, Wt)
            with timer.stage("lasso_emit"):
                best_l = np.argmin(crit_l, axis=1)
                for f, (rep, fold) in enumerate(tags):
                    bidx = int(best_l[f])
                    cvs.append(
                        _emit_lasso(
                            genomes, phi, W[f], V[f],
                            np.asarray(preds_l[f, bidx], dtype=np.float64),
                            np.asarray(B_l[f, :, bidx], dtype=np.float64),
                            float(b0_l[f, bidx]), trait, rep, fold,
                            float(lasso_np[bidx]), store_effects,
                        )
                    )
    return cvs


def _emit_fit_cv(genomes, phi, w, v, pred, b_hat, model, trait, rep, fold, extras) -> CV:
    """Fit + CV of one fold: the fit on the training rows, the CV on the
    validation rows. Without effects, b_hat is the intercept slot alone."""
    pred = np.asarray(pred, dtype=np.float64)
    rows = np.flatnonzero(v > 0)
    tr_rows = np.flatnonzero(w > 0)
    if b_hat is not None:
        labels = np.concatenate([np.asarray(["intercept"], dtype=object), genomes.loci_alleles])
    else:
        b_hat = np.zeros(1)
        labels = np.asarray(["intercept"], dtype=object)
    fit = Fit(
        model=model,
        b_hat=b_hat,
        b_hat_labels=labels,
        trait=trait,
        entries=genomes.entries[tr_rows],
        populations=genomes.populations[tr_rows],
        y_true=phi[tr_rows],
        y_pred=pred[tr_rows],
        metrics=metrics(phi[tr_rows], pred[tr_rows]),
        extras=extras,
    )
    return CV(
        replication=rep,
        fold=fold,
        fit=fit,
        validation_populations=genomes.populations[rows],
        validation_entries=genomes.entries[rows],
        y_true=phi[rows],
        y_pred=pred[rows],
        metrics=metrics(phi[rows], pred[rows]),
    )


def _emit_dual(genomes, phi, w, v, pred, beta, x_mean, model, trait, rep, fold, lam, store_effects):
    """Assemble Fit+CV for a dual-form (ridge/gblup) fold solution; `beta`
    is the fold's marker effects Zᵀ(w ⊙ γ) (None without effects)."""
    b_hat = None
    if store_effects:
        wf = np.asarray(w, dtype=np.float64)
        mean_y = float((wf * np.where(wf > 0, phi, 0.0)).sum() / wf.sum())
        b_hat = np.concatenate([[mean_y - float(x_mean @ beta)], beta])
    extras = {"lambda": lam, "engine": "batched" if model == "ridge" else "batched-reml"}
    return _emit_fit_cv(genomes, phi, w, v, pred, b_hat, model, trait, rep, fold, extras)


def _emit_gibbs(genomes, phi, w, v, pred, mu, beta, model, trait, rep, fold, store_effects):
    """Fit + CV of one fold's Gibbs posterior-mean solution (mu, beta)."""
    b_hat = np.concatenate([[mu], beta]) if store_effects else None
    return _emit_fit_cv(genomes, phi, w, v, pred, b_hat, model, trait, rep, fold,
                        {"engine": "batched-gibbs"})


def _emit_lasso(genomes, phi, w, v, pred, beta, b0, trait, rep, fold, lam, store_effects):
    b_hat = np.concatenate([[b0], beta]) if store_effects else None
    return _emit_fit_cv(genomes, phi, w, v, pred, b_hat, "lasso", trait, rep, fold,
                        {"lambda": lam, "engine": "batched"})
