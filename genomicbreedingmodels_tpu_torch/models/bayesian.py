"""Blocked Gibbs samplers for the Bayesian alphabet (Bayes A/B/C, Bayesian
ridge, Bayesian LASSO, BLπ, BayesT, BayesTπ), torch port of
genomicbreedingmodels_tpu/models/bayesian.py.

This replaces the reference's subprocess FFI to R's BGLR package (reference
src/bayes.jl:28-105). The chain is a Python loop of torch operations on
`device`: sweeps, and within each sweep a blocked marker update that keeps
every n-dimensional operation a GEMV against the centered panel. Markers are
partitioned into blocks of `block_size`; per block u = X_bᵀr is one GEMV and
the block Gram C_b = X_bᵀX_b is computed once per chain. The within-block
update is one of five plain functions, chosen per model and
`indicator_update`:

(a) `_block_kernel` — K3, the grouped 2^K-pattern collapsed draw as one
    hand-written CUDA kernel per block (kernels/gibbs_group.py), for the
    indicator models (BayesB/C, BLπ, BayesTπ);
(b) `_block_grouped_hoisted` — the same law with the pattern factors built
    once per sweep for every block (`group_tables`), when they fit;
(c) `_block_grouped` — the same law with the factors built per block: K3's
    plain version itself (BL rides it degenerated to the all-ones pattern);
(d) `_block_scalar` — the one-marker-at-a-time scan, the equivalence oracle;
(e) `_block_joint` — the joint Gaussian block draw of the continuous priors
    (BayesA, BRR, BayesT), hoisted (one batched factorization per sweep) or
    in-step.

All five target the same posterior. `_sweep` then draws the intercept, the
ordinal liabilities (probit), σ²ₑ, the marker variances and π, and
accumulates the posterior after burn-in. σ²ₑ, π and the other scalars stay
tensors on the device and the traces are read back once, at the end: no
block or sweep waits on the host. Random numbers come from explicit
torch.Generators (Gamma and χ² variates through `torch._standard_gamma`), so
the chain differs draw by draw from the JAX chain (threefry) and is held to
it by posterior statistics.

The chain carries a leading fold axis: F independent chains run as one, each
with its own generator, state and row mask (`gibbs_cv_folds`, the
fold-batched cross-validation of the Bayesian zoo). Every block step is one
batched product for all F folds, K3 updates the block of every fold in one
launch, and each fold draws its noise from its own generator in a fixed
order (a sweep's normals and Gumbel or uniform draws for every block first,
then the intercept, σ²ₑ, the marker variances and π), so fold f of a batch
is the chain fold f runs alone. `gibbs_regression` runs F = 1 without a
mask. A row-masked fold holds its own centered copy of the panel,
(X − μ_f)⊙m_f with μ_f the training rows' column means, as the JAX chain
does under vmap: its held-out rows are zero, so they contribute nothing to
u = X_bᵀr, the block Grams or the residual, and the entry count n becomes
n_eff = Σm_f in the intercept draw, the residual χ² and the inits. At the
JAX bench's cv cell (2048 × 32768, 15 folds) the copies take 4.1 GB and the
block Grams 0.5 GB.

Priors follow BGLR's gaussian defaults (R2=0.5, df=5, scaled-inverse-χ²
residual and marker variances, Beta-updated inclusion probability for Bayes
B/C).

Over a mesh of ranks (parallel/mesh.py): `gibbs_cv_folds(mesh=)` spreads
the folds over the ranks, and the marker-sharded chain
(parallel/sharded.py:sharded_gibbs_regression) runs `_gibbs_chain` on each
rank's column shard with `shard` set (JAX `axis_name` / `seq_rounds`).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.structs import Fit, Genomes, Phenomes
from ..device import resolve_device
from ..kernels.gibbs_group import (
    MAX_K,
    group_scan,
    group_tables,
    grouped_block_update,
    grouped_block_update_plain,
    pattern_bits,
)
from ..ops.metrics import metrics
from ..prediction import extractxyetc
from ..utils.checkpoint import load_state, save_state
from ..utils.config import get_config
from ..utils.devcache import SingleSlotCache, host_fingerprint
from ..utils.diagnostics import ess, mcmc_diagnostics

# Centered padded device panel (and its column means) of the most recent
# host-panel chain (gibbs_regression).
_PANEL_CACHE = SingleSlotCache()

__all__ = [
    "gibbs_regression",
    "gibbs_cv_folds",
    "bglr",
    "bayesian",
    "bayesa",
    "bayesb",
    "bayesc",
    "bayesian_ridge",
    "bayesian_lasso",
    "bayesian_lasso_pi",
    "bayest",
    "bayestpi",
    "BAYESIAN_MODELS",
]

BAYESIAN_MODELS = ("BayesA", "BayesB", "BayesC", "BRR", "BL", "BLPi", "BayesT", "BayesTPi")

_MODEL_IDS = {m: i for i, m in enumerate(BAYESIAN_MODELS)}
_INDICATOR = ("BayesB", "BayesC", "BLPi", "BayesTPi")
_GROUP_TABLE_FLOATS = int(3.6e8)  # hoist gate of the grouped pattern tables
# Hoist gates of the joint-draw L⁻¹ tables: the reference's 1e8 floats for
# one chain, 1 GB for fold chains. At the cv cell's 15 folds (15·128·256²
# floats) the hoisted BRR sweep took 0.033–0.043 s against 0.124–0.153 s in
# the step on an H100 (scripts/torch_fold_chain_paths.py); a single chain
# between the two gates was not measured, so it keeps the reference's.
_JOINT_TABLE_FLOATS = int(1e8)
_FOLD_JOINT_TABLE_FLOATS = int(2.5e8)


def _gamma(gen, alpha, shape=(), device=None):
    """Gamma(alpha, 1) from `gen` (torch.distributions would use the global RNG).
    A float alpha is filled on the device, never copied from the host."""
    if isinstance(alpha, torch.Tensor):
        a = alpha.expand(shape).contiguous()
    else:
        a = torch.full(shape, float(alpha), dtype=torch.float32, device=device)
    return torch._standard_gamma(a, generator=gen)


def _gumbel(gen, shape, device):
    """−log(−log U), U uniform clamped to [1e-12, 1 − 1e-7] as in the reference."""
    u = torch.rand(shape, generator=gen, device=device)
    return u.clamp_(1e-12, 1.0 - 1e-7).log_().neg_().log_().neg_()


# Per-fold draws: fold f's numbers come from gens[f] alone, stacked on a
# leading fold axis (a float parameter is shared, an (F,) tensor is per fold).


def _fold_randn(gens, shape, dev):
    return torch.stack([torch.randn(shape, generator=g, device=dev) for g in gens])


def _fold_rand(gens, shape, dev):
    return torch.stack([torch.rand(shape, generator=g, device=dev) for g in gens])


def _fold_gamma(gens, alpha, shape, dev):
    per = isinstance(alpha, torch.Tensor)
    return torch.stack([_gamma(g, alpha[f] if per else alpha, shape, dev) for f, g in enumerate(gens)])


def _fold_chi2(gens, df, shape, dev):
    """χ²(df) = 2·Gamma(df/2) per fold."""
    return 2.0 * _fold_gamma(gens, df / 2.0, shape, dev)


def _inverse_gaussian(mu, lam, v, u):
    """IG(mu, lam) from v = ν², ν ~ N(0, 1), and u ~ U(0, 1) (Michael, Schucany
    and Haas 1976): the smaller root x = mu + mu²v/(2lam) − (mu/2lam)·√(4·mu·lam·v
    + mu²v²), then mu²/x unless u ≤ mu/(mu + x). The root is taken in the form
    4·mu²·lam·v / (mu·v + √(mu²v² + 4·mu·lam·v))², a sum of positive terms: the
    textbook form (the JAX package's, bayesian.py:776-780) cancels in float32
    once mu·v ≫ lam, giving x ≤ 0 for half the draws at mu/lam = 2e4, and
    through the clamps τ² at its cap."""
    muv = mu * v
    x = 4.0 * mu * muv * lam / (muv + torch.sqrt(muv * muv + 4.0 * lam * muv)) ** 2
    x = torch.where(muv > 0, x, mu)  # v = 0: the root is mu (0/0 above)
    return torch.where(u <= mu / (mu + x), x, mu * mu / torch.clamp(x, min=1e-20))


@dataclass
class _Panel:
    """What the chain derives once from the design, per fold: the centered
    panel, its column means, the per-marker sums of squares and the block
    Grams (block-major, so one block of every fold is one contiguous slab)."""

    X: torch.Tensor  # (F, n, p_pad) float32, centered (and row-masked)
    mu_cols: torch.Tensor  # (F, p_pad)
    x2: torch.Tensor  # (F, p_pad)
    C: torch.Tensor  # (n_blocks, F, bs, bs)


@dataclass
class _Shard:
    """A marker-sharded chain's place on its mesh (see `_gibbs_chain`)."""

    mesh: object  # parallel/mesh.py:Mesh
    axis: str
    seq_rounds: int  # D for the sequential schedule, 1 for the concurrent one
    marker_gens: Sequence[torch.Generator]  # this rank's per-marker generator


def _center_(Xp: torch.Tensor) -> torch.Tensor:
    """Center the columns of Xp IN PLACE and return their means. Callers pass
    a panel the port owns (its own padded copy), so no second panel-sized
    buffer is made: at 10k×102k that is 4.1 GB saved."""
    mu_cols = Xp.mean(dim=0)
    Xp.sub_(mu_cols)
    return mu_cols


def _setup(Xc: torch.Tensor, mu_cols: torch.Tensor, block_size: int, n_blocks: int) -> _Panel:
    """Block Grams of the centered panels: one batched product per block for
    all folds, into one (n_blocks, F, bs, bs) buffer (no block-major copy of
    the panel). x2 is the Grams' diagonal."""
    bs = block_size
    F = Xc.shape[0]
    C = torch.empty((n_blocks, F, bs, bs), dtype=torch.float32, device=Xc.device)
    for blk in range(n_blocks):
        Xb = Xc[:, :, blk * bs : (blk + 1) * bs]
        torch.bmm(Xb.transpose(1, 2), Xb, out=C[blk])
    x2 = C.diagonal(dim1=2, dim2=3).transpose(0, 1).reshape(F, -1).clone()
    return _Panel(X=Xc, mu_cols=mu_cols, x2=x2, C=C)


# -- within-block updates: each returns (delta, b_new, incl), all (F, bs) -------


def _block_kernel(Cb, u, b_blk, s2_blk, val_blk, normals, gum, sig_e2, pi_in, K):
    """(a) K3: the whole within-block group scan of every fold as one kernel launch."""
    return grouped_block_update(Cb, u, b_blk, s2_blk, val_blk, normals, gum, sig_e2, pi_in, K=K)


def _block_grouped_hoisted(tables, Cb, u, b_blk, val_blk, normals, gum, sig_e2, patterns):
    """(b) Grouped draw from this block's slice of the sweep's tables: each
    group step is only Z = W̃v, the Gumbel-argmax and b = W̃ᵀ(Z + η)."""
    W, const = tables
    return group_scan(W, const, gum, Cb, u, b_blk, normals, sig_e2, patterns, val_blk)


def _block_grouped(Cb, u, b_blk, s2_blk, val_blk, normals, gum, sig_e2, pi_in, K, patterns):
    """(c) Grouped draw with the block's pattern factors built in the step:
    K3's plain version."""
    return grouped_block_update_plain(
        Cb, u, b_blk, s2_blk, val_blk, normals, gum, sig_e2, pi_in, K, patterns=patterns
    )


def _block_scalar(Cb, u, b_blk, s2_blk, val_blk, x2_blk, normals, uniforms, sig_e2, pi_in,
                  has_indicator):
    """(d) One marker at a time, exact sequential Gibbs. Markers already
    updated in this block enter through the rows of Cb (length-bs axpys),
    not through the length-n residual."""
    sig = sig_e2[:, None]
    prec = x2_blk / sig + 1.0 / s2_blk
    coef = 1.0 / (sig * prec)  # mean = x_jᵀ(residual without j)/σ²ₑ/prec
    spread = torch.sqrt(1.0 / prec) * normals
    # wn[:, j] = u_j − cdelta_j + x2_j·b_j: marker j's own effect is untouched
    # until its step, so x2·b enters once and the steps subtract C rows.
    wn = u + x2_blk * b_blk
    if has_indicator:
        # Marginal (effect-integrated) inclusion odds; u < sigmoid(x) is
        # logit(u) < x, and invalid markers never enter.
        lo0 = (torch.log(pi_in / (1.0 - pi_in))[:, None] - 0.5 * torch.log(s2_blk * prec)).unbind(1)
        hp = (0.5 * prec).unbind(1)
        thr = torch.where(val_blk > 0, torch.logit(uniforms), float("inf")).unbind(1)
    val = val_blk.unbind()
    coef, spread, b_old = coef.unbind(1), spread.unbind(1), b_blk.unbind(1)
    rows, wn_j = Cb.unbind(1), wn.unbind(1)
    new, picks = [], []
    for j in range(Cb.shape[1]):
        mean = wn_j[j] * coef[j]
        b_new = mean + spread[j]
        if has_indicator:
            inc = thr[j] < lo0[j] + mean * mean * hp[j]
            b_new = torch.where(inc, b_new, 0.0)
            picks.append(inc)
        else:
            b_new = b_new * val[j]
        wn.addcmul_(rows[j], (b_old[j] - b_new)[:, None])
        new.append(b_new)
    b_new = torch.stack(new, 1)
    incl = torch.stack(picks, 1).to(torch.float32) if has_indicator else torch.ones_like(b_new)
    return b_new - b_blk, b_new, incl


def _joint_tables(C, s2, sig_e2, valid):
    """Batched L⁻¹ of every block's joint-draw precision C_b/σ²ₑ + diag(1/s²),
    (n_blocks, F, bs, bs). Padded markers carry zero Gram rows and a pinned
    unit diagonal, so their L⁻¹ rows/cols are e_k and the draw is finite there."""
    nb, F, bs, _ = C.shape
    s2b = s2.view(F, nb, bs).transpose(0, 1)
    dinv = torch.where(valid.view(nb, 1, bs) > 0, 1.0 / torch.clamp(s2b, min=1e-12), 1.0)
    L = torch.linalg.cholesky_ex(C / sig_e2[:, None, None] + torch.diag_embed(dinv))[0]
    eye = torch.eye(bs, dtype=C.dtype, device=C.device).expand(nb, F, bs, bs)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def _block_joint(Linv_b, Cb, u, b_blk, s2_blk, val_blk, normals, sig_e2):
    """(e) The block conditional of a continuous prior is jointly Gaussian,
    N(P⁻¹rhs, P⁻¹) with P = C_b/σ²ₑ + D⁻¹ and rhs = (u + C_b·b_b)/σ²ₑ: one
    exact block draw. Hoisted (Linv_b given): mean + L⁻ᵀη as two GEMVs."""
    rhs = (u + (Cb @ b_blk[..., None])[..., 0]) / sig_e2[:, None]
    if Linv_b is not None:
        # (w + η) @ L⁻¹ = L⁻ᵀ(w + η)
        b_new = (((Linv_b @ rhs[..., None])[..., 0] + normals)[:, None, :] @ Linv_b)[:, 0]
    else:
        dinv = torch.where(val_blk > 0, 1.0 / torch.clamp(s2_blk, min=1e-12), 1.0)
        L = torch.linalg.cholesky_ex(Cb / sig_e2[:, None, None] + torch.diag_embed(dinv))[0]
        mean = torch.cholesky_solve(rhs[..., None], L)[..., 0]
        b_new = mean + torch.linalg.solve_triangular(L.transpose(1, 2), normals[..., None],
                                                     upper=True)[..., 0]
    b_new = torch.where(val_blk > 0, b_new, 0.0)
    return b_new - b_blk, b_new, torch.ones_like(b_new)


# -- hyperparameters and the initial state -------------------------------------


def _hyper(model: str, var_y: float, ms_x: float, p: int, r2: float,
           fix_sigma_e2=None, fix_sigma_b2=None) -> dict:
    """BGLR-default hyperparameters, as Python floats."""
    df_b, df_e = 5.0, 5.0
    pi_in = 0.5 if model in _INDICATOR else 1.0
    S_b0 = var_y * r2 / ms_x * (df_b + 2.0) / pi_in
    # π prior counts: BGLR's informative Beta (counts=10) for BayesB/C; the
    # reference's Turing spec (src/bayes.jl:851-852) uses Beta(1, 1) for the
    # Lπ/Tπ variants.
    pi_counts = 10.0 if model in ("BayesB", "BayesC") else 2.0
    if model in ("BayesT", "BayesTPi"):
        # Fixed unscaled t prior TDist(1.0) (reference src/bayes.jl:752, :853).
        df_b, S_b0 = 1.0, 1.0
    hyper = {
        "df_b": df_b, "S_b0": S_b0, "df_e": df_e,
        "S_e0": var_y * (1.0 - r2) * (df_e + 2.0),
        "pi_in": pi_in, "pi_counts": pi_counts,
        "lam2_0": 2.0 * (1.0 - r2) / r2 * ms_x / max(p, 1),
    }
    if fix_sigma_e2 is not None:
        hyper["fix_e"] = float(fix_sigma_e2)
        hyper["fix_b"] = float(fix_sigma_b2)
    return hyper


def _initial_state(y, hyper, model_id, F, p_pad, response_id, n_cats, pinned, gens, row_mask=None):
    """The F chains' 13-component state at sweep 0 (component 7 is the
    generators' states, an (F, ·) uint8 tensor on the host). A row-masked
    fold starts from its training rows alone (JAX bayesian.py:857-862):
    mu0 = Σ(y·m)/n_eff and r0 = (y − mu0)·m, so held-out residuals are zero."""
    dev = y.device
    n = y.shape[0]

    def full(shape, v):
        return torch.full(shape, float(v), dtype=torch.float32, device=dev)

    n_gam = max(n_cats - 1, 1)
    if response_id == 1:
        # Latent liabilities start at the standardized category codes;
        # interior thresholds equally spaced.
        z0 = ((y - y.mean()) / torch.clamp(y.std(correction=0), min=1e-6)).expand(F, n).clone()
        gam0 = torch.linspace(0.0, 1.0, n_gam, dtype=torch.float32, device=dev).expand(F, n_gam).clone()
        mu0, sig0 = full((F,), 0.0), full((F,), 1.0)
        r0 = z0 - mu0[:, None]
    elif row_mask is not None:
        z0, gam0 = y.expand(F, n).clone(), full((F, n_gam), 0.0)
        n_eff = row_mask.sum(1)
        mu0 = (y * row_mask).sum(1) / n_eff
        r0 = (y - mu0[:, None]) * row_mask
        sig0 = (r0 * r0).sum(1) / n_eff * 0.5
    else:
        z0, gam0 = y.expand(F, n).clone(), full((F, n_gam), 0.0)
        mu0 = y.mean().expand(F).clone()
        r0 = (y - y.mean()).expand(F, n).clone()
        sig0 = (y.var(correction=0) * 0.5).expand(F).clone()
    if pinned:
        sig0 = full((F,), hyper["fix_e"])
    s2_init = hyper["fix_b"] if pinned else hyper["S_b0"] / max(hyper["df_b"] - 2.0, 0.5)
    is_bl = model_id in (_MODEL_IDS["BL"], _MODEL_IDS["BLPi"])
    return (
        full((F, p_pad), 0.0),  # b
        r0,  # r
        full((F, p_pad), s2_init),  # s2
        sig0,  # sig_e2
        mu0,  # mu
        full((F,), hyper["pi_in"]),  # pi
        full((F,), hyper["lam2_0"] if is_bl else hyper["S_b0"]),  # S_scale / λ²
        torch.stack([g.get_state() for g in gens]),
        full((F, p_pad), 0.0),  # acc_b
        full((F,), 0.0),  # acc_mu
        full((F,), 0.0),  # acc_n
        z0,
        gam0,
    )


# -- the chain -------------------------------------------------------------------


def _gibbs_chain(
    panel: _Panel,
    y: torch.Tensor,  # (n,) float32 on the panel's device
    valid: torch.Tensor,  # (p_pad,) 1.0 for real markers
    gens: Sequence[torch.Generator],  # one per fold
    hyper: dict,
    model_id: int,
    n_iter: int,
    n_burnin: int,
    block_size: int,
    n_blocks: int,
    response_id: int = 0,
    n_cats: int = 0,
    iters=None,
    state_in=None,
    return_state: bool = False,
    pinned: bool = False,
    group_size: int = 0,
    pallas_groups: bool = False,
    row_mask: Optional[torch.Tensor] = None,  # (F, n) {0, 1} training rows
    batch_hint: Optional[int] = None,
    shard: Optional[_Shard] = None,
):
    """Run `n_iter` sweeps (global indices `iters`, for burn-in accounting)
    of the F = len(gens) chains from `state_in` or the initial state; returns
    (mu (F,), b_mean (F, p_pad), traces[, state]) with traces = (σ²ₑ per
    sweep (T, F), the first 8 effects per sweep (T, F, 8), the centered
    intercept per sweep (T, F)).

    One long run and N chained segments give the bit-identical chain: the
    generators' states ride in the state tuple.

    `batch_hint` is the number of fold chains the hoist gates count (F by
    default): a fold batch split over ranks passes the whole batch's F, so
    every rank takes the paths, hence the arithmetic, of the unsplit batch.

    `shard` runs one chain marker-sharded over a mesh axis
    (parallel/sharded.py:sharded_gibbs_regression, JAX bayesian.py:105-167):
    the panel is this rank's column shard, the residual r stays replicated
    by an all-reduce of each block round's n-vector X_b·δ, and the sums over
    markers (Σvalid, the marker-variance and π statistics, μ's centering
    term) are all-reduced. Per-marker draws come from the rank's own
    generator (`shard.marker_gens`, from (seed, rank), standing for the JAX
    fold_in of the device index); the scalar draws from `gens`, the same on
    every rank. "sequential" (`shard.seq_rounds` = D) splits each block
    round into D turns and only rank `turn` updates its block, against the
    residual every earlier turn left (exact Gauss-Seidel across ranks);
    "concurrent" (1) updates every rank's block against the round-start
    residual (block-Jacobi). Each rank's block update is its own K3 launch
    on the indicator models."""
    X, C = panel.X, panel.C
    F, n, p_pad = X.shape
    gens_m = gens if shard is None else shard.marker_gens
    D = 1 if shard is None else shard.mesh.shape[shard.axis]

    def psum(v):
        return v if D == 1 else shard.mesh.allreduce(v.reshape(-1), shard.axis).view(v.shape)
    dev = X.device
    bs = block_size
    model = BAYESIAN_MODELS[model_id]
    masked = row_mask is not None
    if masked and response_id == 1:
        raise ValueError("row-masked chains support gaussian responses only")
    # Row-masked folds count only their training rows (JAX bayesian.py:177-188).
    n_eff = row_mask.sum(1) if masked else torch.full((F,), float(n), device=dev)
    # gibbs_regression's one chain: plain GEMVs and K3's single-chain launch
    # (the fold path's batched products and fold launch cost it host time).
    single = F == 1 and not masked
    has_indicator = model in _INDICATOR
    per_marker_var = model in ("BayesA", "BayesB", "BL", "BLPi", "BayesT", "BayesTPi")
    is_bl = model in ("BL", "BLPi")
    # BayesT/BayesTπ (reference src/bayes.jl:745-855): the per-marker scaled-
    # inv-χ² machinery of BayesA with the hyper-scale S pinned.
    fixed_scale = model in ("BayesT", "BayesTPi")
    p_real = float(psum(valid.sum()))  # once per segment
    grouped = group_size > 1 and (has_indicator or model == "BL")
    hoist_groups, hoist_joint = _hoists(model, bs, p_pad, group_size, pallas_groups,
                                        F if batch_hint is None else batch_hint)
    if grouped:
        K = group_size
        gpb = bs // K
        n_pat = (1 << K) if has_indicator else 1
        patterns = pattern_bits(K, dev, indicator=has_indicator)
        Cgg = C.view(n_blocks, F, gpb, K, gpb, K).diagonal(dim1=2, dim2=4).permute(0, 1, 4, 2, 3)
    is_ordinal = response_id == 1
    if is_ordinal:
        y_code = y.to(torch.long)
        big = 1e10

    def sweep_noise():
        """This sweep's within-block noise of every fold, block-major:
        normals (n_blocks, F, bs), and Gumbel draws (n_blocks, F, G, 2^K)
        or uniforms (n_blocks, F, bs) for the indicator models."""
        normals = torch.stack([torch.randn(p_pad, generator=g, device=dev).view(n_blocks, bs)
                               for g in gens_m], 1)
        gum = uniforms = None
        if grouped and has_indicator:
            gum = torch.stack([_gumbel(g, (n_blocks, gpb, n_pat), dev) for g in gens_m], 1)
        elif has_indicator:
            uniforms = torch.stack([torch.rand(p_pad, generator=g, device=dev).view(n_blocks, bs)
                                    for g in gens_m], 1)
        return normals, gum, uniforms

    def block_update(blk, b, r, s2, sig_e2, pi_in, tables, noise):
        sl = slice(blk * bs, (blk + 1) * bs)
        Xb = X[:, :, sl]
        if single:
            u = torch.mv(Xb[0].T, r[0])[None]
        else:
            u = torch.bmm(r[:, None, :], Xb)[:, 0]  # (F, bs): one batched GEMV
        b_blk, s2_blk, val_blk, Cb = b[:, sl], s2[:, sl], valid[sl], C[blk]
        normals = noise[0][blk]
        if grouped:
            gum = noise[1][blk] if has_indicator else None
            if pallas_groups and single:
                out = tuple(o[None] for o in _block_kernel(
                    Cb[0], u[0], b_blk[0], s2_blk[0], val_blk, normals[0], gum[0], sig_e2, pi_in, K))
            elif pallas_groups:
                out = _block_kernel(Cb, u, b_blk, s2_blk, val_blk, normals, gum, sig_e2, pi_in, K)
            elif tables is not None:
                out = _block_grouped_hoisted(
                    (tables[0][blk], tables[1][blk]), Cb, u, b_blk, val_blk, normals, gum,
                    sig_e2, patterns,
                )
            else:
                out = _block_grouped(Cb, u, b_blk, s2_blk, val_blk, normals, gum, sig_e2, pi_in,
                                     K, patterns)
        elif has_indicator or is_bl:
            # Indicator models need per-marker discrete draws; BL keeps the
            # scalar scan too when not grouped: its σ²ₑ-proportional shrinkage
            # turns the full-block joint draw's null-space moves into a
            # positive feedback loop when p > n.
            uniforms = noise[2][blk] if has_indicator else None
            out = _block_scalar(Cb, u, b_blk, s2_blk, val_blk, panel.x2[:, sl], normals, uniforms,
                                sig_e2, pi_in, has_indicator)
        else:
            out = _block_joint(None if tables is None else tables[blk], Cb, u, b_blk, s2_blk,
                               val_blk, normals, sig_e2)
        delta, b_new, incl = out
        b[:, sl] = b_new
        if D > 1:  # the caller all-reduces X_b·δ into the replicated residual
            return incl, torch.mv(Xb[0], delta[0])
        if single:
            r[0].addmv_(Xb[0], delta[0], alpha=-1.0)
        else:
            # r −= X_b·δ as a row vector times X_bᵀ: on the host this product
            # rounds each fold alike whatever F is (X_b·δ as a column does not).
            r[:, None, :].baddbmm_(delta[:, None, :], Xb.transpose(1, 2), alpha=-1.0)
        return incl

    def sharded_blocks(b, r, s2, sig_e2, pi_in, tables, noise):
        """The block rounds of a marker-sharded sweep (see `shard`)."""
        me = shard.mesh.index(shard.axis)
        parts = []
        for blk in range(n_blocks):
            for turn in range(shard.seq_rounds):
                if shard.seq_rounds == 1 or turn == me:
                    incl_b, v = block_update(blk, b, r, s2, sig_e2, pi_in, tables, noise)
                    parts.append(incl_b)
                else:  # another rank's turn: add nothing, receive its X_b·δ
                    v = torch.zeros(n, dtype=r.dtype, device=dev)
                r[0].sub_(psum(v))
        return torch.cat(parts, 1)

    def sweep(state, it):
        b, r, s2, sig_e2, mu, pi_in, S_scale, _, acc_b, acc_mu, acc_n, z, gam = state
        noise = sweep_noise()
        # 1) Marker effects, blocked-exact Gibbs.
        if hoist_groups:
            tables = group_tables(Cgg, s2.view(F, n_blocks, gpb, K).transpose(0, 1),
                                  valid.view(n_blocks, 1, gpb, K), patterns, sig_e2[:, None],
                                  pi_in[:, None])
        elif hoist_joint:
            tables = _joint_tables(C, s2, sig_e2, valid)
        else:
            tables = None
        if D > 1:
            incl = sharded_blocks(b, r, s2, sig_e2, pi_in, tables, noise) * valid
        else:
            incl = torch.cat([block_update(blk, b, r, s2, sig_e2, pi_in, tables, noise)
                              for blk in range(n_blocks)], 1) * valid
        active = incl if has_indicator else valid.expand(F, p_pad)

        # 2) Intercept (JAX bayesian.py:718-720: n_eff and the mask when masked).
        mu_new = mu + r.sum(1) / n_eff + torch.sqrt(sig_e2 / n_eff) * _fold_randn(gens, (), dev)
        shift = (mu_new - mu)[:, None]
        r = r - (shift * row_mask if masked else shift)
        mu = mu_new

        if is_ordinal:
            # 2b) Albert-Chib probit augmentation: y holds category codes
            # 0..C-1; the latent liability z replaces the response and the
            # residual variance is fixed at 1 (probit identification).
            eta = z - r
            lo_k = torch.stack([torch.where(y == k, z, -big).amax(1) for k in range(n_cats - 1)], 1)
            hi_k = torch.stack([torch.where(y == k + 1, z, big).amin(1) for k in range(n_cats - 1)], 1)
            u_g = _fold_rand(gens, (n_cats - 1,), dev)
            gam = lo_k + u_g * (hi_k - lo_k)
            gam[:, 0] = 0.0  # identifiability
            edge = torch.full((F, 1), big, device=dev)
            full_gam = torch.cat([-edge, gam, edge], 1)
            lo, hi = full_gam[:, y_code], full_gam[:, y_code + 1]
            # Truncated-normal draw by inverse CDF.
            a = torch.special.ndtr(lo - eta)
            bcdf = torch.special.ndtr(hi - eta)
            u_z = _fold_rand(gens, (n,), dev).clamp_(1e-6, 1.0 - 1e-6)
            q = torch.clamp(a + u_z * (bcdf - a), 1e-6, 1.0 - 1e-6)
            z = eta + torch.special.ndtri(q)
            r = z - eta
            sig_e2 = torch.ones(F, device=dev)
        else:
            # 3) Residual variance: σ²ₑ = (SSE + Sₑ) / χ²(n_eff + dfₑ) (BGLR);
            # masked rows carry r = 0 (JAX bayesian.py:762).
            sig_e2 = ((r * r).sum(1) + hyper["S_e0"]) / _fold_chi2(gens, hyper["df_e"] + n_eff, (), dev)
        if pinned:
            # Oracle mode: variances held fixed so the marker-effect
            # posterior is exactly Gaussian (conjugate).
            sig_e2 = torch.full((F,), hyper["fix_e"], device=dev)

        # 4) Marker variances.
        df_b, S_b0 = hyper["df_b"], hyper["S_b0"]
        sig = sig_e2[:, None]
        if per_marker_var:
            if is_bl:
                # Bayesian LASSO: τ²ⱼ via inverse-Gaussian; λ² via Gamma.
                lam2 = S_scale[:, None]
                mu_ig = torch.sqrt(lam2 * sig / torch.clamp(b * b, min=1e-12))
                nrm = _fold_randn(gens_m, (p_pad,), dev)
                inv_tau2 = _inverse_gaussian(mu_ig, lam2, nrm * nrm, _fold_rand(gens_m, (p_pad,), dev))
                s2 = torch.clamp(sig / torch.clamp(inv_tau2, min=1e-12), 1e-10, 1e6)
                if has_indicator:
                    # BLπ: excluded markers refresh τ² from its prior
                    # Exp(λ²/2), not the b=0-degenerate inverse-Gaussian.
                    u_pr = _fold_rand(gens_m, (p_pad,), dev).clamp_(min=1e-12)
                    tau2_prior = -2.0 * torch.log(u_pr) / torch.clamp(lam2, min=1e-12)
                    s2_prior = torch.clamp(sig * tau2_prior, 1e-10, 1e6)
                    s2 = torch.where(active > 0, s2, s2_prior)
                # λ² | τ² ~ Gamma(p + shape, Στ²/2 + rate)
                tau2_sum = psum(torch.where(valid > 0, s2 / sig, 0.0).sum(1))
                lam2 = _fold_gamma(gens, p_real + 1.1, (), dev) / (0.5 * tau2_sum + 1.1 / hyper["lam2_0"])
                # Keep λ² in a safe f32 range: the shrinkage feedback
                # (σ²ₑ↓ → Στ²↑ → λ²↓ → τ²↑) can otherwise underflow λ²·σ²ₑ.
                S_scale = torch.clamp(lam2, 1e-10, 1e10)
            else:
                # Scaled-t (BayesA/B): σ²ⱼ | bⱼ ~ (S + bⱼ²)/χ²(df+1) when
                # active, prior draw S/χ²(df) when excluded.
                chis = _fold_chi2(gens_m, df_b + 1.0, (p_pad,), dev)
                chis0 = _fold_chi2(gens_m, df_b, (p_pad,), dev)
                S = S_scale[:, None]
                s2 = torch.where(active > 0, (S + b * b) / chis, S / chis0)
                s2 = torch.clamp(s2, 1e-10, 1e6)
                if not fixed_scale:
                    inv_sum = psum(torch.where(valid > 0, 1.0 / s2, 0.0).sum(1))
                    S_scale = _fold_gamma(gens, p_real * df_b / 2.0 + 1.1, (), dev) / (
                        0.5 * inv_sum + 1.1 / S_b0
                    )
        else:
            # Common slab variance (BayesC / BRR).
            ssb = psum(torch.where(active > 0, b * b, 0.0).sum(1))
            nb = psum(active.sum(1))
            s2_common = (ssb + S_b0 * df_b) / _fold_chi2(gens, df_b + nb, (), dev)
            s2 = torch.clamp(s2_common, 1e-10, 1e6)[:, None].expand(F, p_pad).clone()
        if pinned:
            s2 = torch.full((F, p_pad), hyper["fix_b"], device=dev)

        # 5) Inclusion probability π (BayesB/C, BLπ, BayesTπ).
        if has_indicator:
            n_in = psum(incl.sum(1))
            pi0, counts = hyper["pi_in"], hyper["pi_counts"]
            g1 = _fold_gamma(gens, pi0 * counts + n_in, (), dev)
            g2 = _fold_gamma(gens, (1.0 - pi0) * counts + (p_real - n_in), (), dev)
            pi_in = torch.clamp(g1 / (g1 + g2), 1e-4, 1.0 - 1e-4)

        # 6) Posterior accumulation after burn-in.
        if it >= n_burnin:
            acc_b = acc_b + b
            acc_mu = acc_mu + mu
            acc_n = acc_n + 1.0
        state = (b, r, s2, sig_e2, mu, pi_in, S_scale, None, acc_b, acc_mu, acc_n, z, gam)
        return state, (sig_e2, b[:, : min(8, p_pad)].clone(), mu)

    # The generators whose states ride in the state (component 7): the
    # scalar ones, then a sharded chain's own per-marker one.
    all_gens = list(gens) + [g for g in gens_m if all(g is not h for h in gens)]
    if state_in is not None:
        for i, g in enumerate(all_gens):
            # A copy, not a row view: set_state of views raced with the row
            # iteration of another rank's thread (torch 2.13 CPU, a segfault).
            g.set_state(state_in[7][i].clone())
        state = tuple(None if i == 7 else v.clone() for i, v in enumerate(state_in))
    else:
        state = _initial_state(y, hyper, model_id, F, p_pad, response_id, n_cats, pinned, gens,
                               row_mask)
    if iters is None:
        iters = range(n_iter)
    sig_tr, b_tr, mu_tr = [], [], []
    for it in iters:
        state, (s, bp, m) = sweep(state, int(it))
        sig_tr.append(s)
        b_tr.append(bp)
        mu_tr.append(m)
    state = state[:7] + (torch.stack([g.get_state() for g in all_gens]),) + state[8:]
    acc_b, acc_mu, acc_n = state[8], state[9], state[10]
    safe_n = torch.clamp(acc_n, min=1e-12)
    b_mean = acc_b / safe_n[:, None]
    # Undo the centering reparametrization: y = mu_c + (X - mu_cols)·b
    #                                         = (mu_c - mu_cols·b) + X·b.
    mu_out = acc_mu / safe_n - psum((panel.mu_cols * b_mean).sum(1))
    traces = (torch.stack(sig_tr), torch.stack(b_tr), torch.stack(mu_tr)) if sig_tr else (
        torch.zeros((0, F), device=dev), torch.zeros((0, F, min(8, p_pad)), device=dev),
        torch.zeros((0, F), device=dev))
    if return_state:
        return mu_out, b_mean, traces, state
    return mu_out, b_mean, traces


def _resolve_update(model, indicator_update, block_size, p, group_size, dev):
    """The within-block path: "pallas" (K3), "grouped" or "scalar"."""
    if indicator_update not in ("auto", "grouped", "pallas", "scalar"):
        raise ValueError(f"unknown indicator_update {indicator_update!r}")
    if indicator_update == "auto":
        # K3 on a CUDA device for the indicator models at block_size <= 1024,
        # with the configured K as it is (the kernel takes any K up to 8; the
        # reference's rounding of K to 8 is a TPU lane constraint); the plain
        # grouped draw everywhere else, including block_size < 8.
        if (dev.type == "cuda" and model in _INDICATOR
                and min(block_size, max(8, p)) <= 1024 and group_size <= MAX_K):
            return "pallas"
        return "grouped"
    return indicator_update


def _plan(model, indicator_update, block_size, p, dev):
    """(update, group_size, bs, p_pad, n_blocks) of a chain over p markers:
    the within-block path, the group size K (0 when not grouped), and the
    block size rounded up to whole groups."""
    K = int(get_config().mcmc_group_size)
    update = _resolve_update(model, indicator_update, block_size, p, K, dev)
    if update in ("grouped", "pallas") and model in _INDICATOR:
        group_size = K
    elif update == "grouped" and model == "BL":
        # BL rides the grouped machinery degenerated to the single all-ones
        # pattern (K-marker joint draws; no kernel variant for this shape).
        group_size = K
    else:
        group_size = 0
    bs = int(min(block_size, max(8, p)))
    if group_size > 1:
        group_size = min(group_size, bs)
        bs = ((bs + group_size - 1) // group_size) * group_size  # bs | K groups
    p_pad = ((p + bs - 1) // bs) * bs
    return update, group_size, bs, p_pad, p_pad // bs


def gibbs_regression(
    X,
    y,
    model: str = "BayesA",
    n_iter: int = None,
    n_burnin: int = None,
    seed: int = 42,
    block_size: int = None,
    n_chains: int = 1,
    r2: float = 0.5,
    response_type: str = "gaussian",
    chunk_size: int = None,
    checkpoint_path: str = None,
    fix_sigma_e2: Optional[float] = None,
    fix_sigma_b2: Optional[float] = None,
    indicator_update: str = None,
    device="cuda",
) -> Tuple[float, np.ndarray, dict]:
    """Run the blocked Gibbs sampler on `device`; returns (mu_hat, b_hat,
    diagnostics).

    `X` is a host array (uploaded once, padded, and cached centered in a
    single slot keyed on its fingerprint) or a torch tensor (copied once to
    float32 on `device`; the caller's tensor is never modified).

    `indicator_update` ("auto" default via GBMConfig) selects the indicator
    models' within-block update: "pallas" = K3, the grouped 2^K-pattern
    collapsed draw as one CUDA kernel per block (a CPU tensor runs its plain
    version; K <= 8), "grouped" = the same exact update in plain torch,
    "scalar" = the one-marker-at-a-time scan (the equivalence oracle). All
    target the identical posterior; "auto" resolves to "pallas" on a CUDA
    device for BayesB/C, BLπ and BayesTπ with block_size <= 1024 and to
    "grouped" elsewhere.

    `fix_sigma_e2`/`fix_sigma_b2` (both required together) pin the residual
    and marker variances, making the marker-effect posterior exactly
    Gaussian (the conjugate-oracle mode).

    `n_chains > 1` runs independent chains one after another and averages
    their posterior means. `response_type="ordinal"` runs Albert-Chib probit
    augmentation on integer category codes; b_hat is then on the latent
    liability scale.

    `chunk_size` runs the chain in segments of that many sweeps (the same
    chain bit for bit), and `checkpoint_path` saves the state after every
    segment and resumes from it (single-chain runs).

    The diagnostics hold the σ²ₑ trace, split-R̂/ESS of σ²ₑ, the mean effect
    ESS over 8 probed markers, the within-block path actually run
    (`update`), and the wall seconds of the prep (upload, centering, block
    Grams) and of the sweeps (`stage_seconds`).
    """
    if model not in _MODEL_IDS:
        raise ValueError(f"unknown Bayesian model {model!r}; choose from {BAYESIAN_MODELS}")
    if response_type not in ("gaussian", "ordinal"):
        raise ValueError(f"unknown response_type {response_type!r}")
    dev = resolve_device(device)
    cfg = get_config()
    # MCMC defaults flow from GBMConfig (reference defaults n_iter=1500,
    # n_burnin=500, src/linear.jl:446-447); override via GBM_MCMC_* env vars.
    n_iter = cfg.mcmc_n_iter if n_iter is None else n_iter
    n_burnin = cfg.mcmc_n_burnin if n_burnin is None else n_burnin
    block_size = cfg.mcmc_block_size if block_size is None else block_size
    indicator_update = cfg.mcmc_indicator_update if indicator_update is None else indicator_update
    if not isinstance(X, torch.Tensor):
        X = np.asarray(X, dtype=np.float32)
    n, p = X.shape
    update, group_size, bs, p_pad, n_blocks = _plan(model, indicator_update, block_size, p, dev)
    pallas_groups = update == "pallas"
    pinned = fix_sigma_e2 is not None or fix_sigma_b2 is not None
    if pinned and (fix_sigma_e2 is None or fix_sigma_b2 is None):
        raise ValueError("fix_sigma_e2 and fix_sigma_b2 must be set together")
    response_id, n_cats = 0, 0
    y = np.asarray(y.cpu() if isinstance(y, torch.Tensor) else y)
    if response_type == "ordinal":
        codes, y = np.unique(y, return_inverse=True)
        n_cats = len(codes)
        if n_cats < 2:
            raise ValueError("ordinal response needs >= 2 categories")
        response_id = 1
    y = np.asarray(y, dtype=np.float32).reshape(-1)

    t0 = time.perf_counter()
    if isinstance(X, torch.Tensor):
        Xp = X.to(device=dev, dtype=torch.float32)
        if p_pad != p:
            Xp = torch.nn.functional.pad(Xp, (0, p_pad - p))
        elif Xp.data_ptr() == X.data_ptr():
            Xp = Xp.clone()  # the caller's tensor is never centered in place
        Xp = Xp.contiguous()
        mu_cols = _center_(Xp)
        ms_x = None  # from the centered panel's sums of squares, below
    else:
        # Repeated chains on the same host panel skip the upload and the
        # centering: the single slot holds the padded CENTERED panel and its
        # column means (utils/devcache.py).
        fp = (host_fingerprint(X), p_pad, str(dev))
        hit = _PANEL_CACHE.get(fp)
        if hit is None:
            Xp = torch.zeros((n, p_pad), dtype=torch.float32, device=dev)
            Xp[:, :p] = torch.from_numpy(X).to(dev)
            hit = _PANEL_CACHE.put(fp, (Xp, _center_(Xp)))
        Xp, mu_cols = hit
        ms_x = float(np.sum(np.var(X, axis=0)))
    panel = _setup(Xp[None], mu_cols[None], bs, n_blocks)
    if ms_x is None:
        ms_x = float(panel.x2[0, :p].sum()) / n  # Σ column variances (ddof 0)
    valid = torch.zeros(p_pad, dtype=torch.float32, device=dev)
    valid[:p] = 1.0
    var_y = 1.0 if response_id == 1 else float(np.var(y, ddof=1))
    hyper = _hyper(model, var_y, max(ms_x, 1e-8), p, r2, fix_sigma_e2, fix_sigma_b2)
    y_t = torch.from_numpy(y).to(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_prep = time.perf_counter() - t0

    def run(gen, **kw):
        """One chain (the fold axis of one): (mu, b_mean, (σ²ₑ trace, effect
        trace)[, state])."""
        out = _gibbs_chain(
            panel, y_t, valid, [gen], hyper, _MODEL_IDS[model], int(n_iter), int(n_burnin), bs,
            n_blocks, response_id=response_id, n_cats=n_cats, pinned=pinned,
            group_size=group_size, pallas_groups=pallas_groups, **kw,
        )
        mu_t, b_t, (sig, bp, _) = out[:3]
        return (mu_t[0], b_t[0], (sig[:, 0], bp[:, 0])) + tuple(out[3:])

    seeds = np.random.SeedSequence(seed).generate_state(n_chains, dtype=np.uint64)
    gens = [torch.Generator(device=dev).manual_seed(int(s) & (2**63 - 1)) for s in seeds]
    t0 = time.perf_counter()
    if n_chains == 1 and chunk_size is not None and chunk_size < n_iter:
        state, done = None, 0
        if checkpoint_path is not None:
            snap = load_state(checkpoint_path)
            if snap is not None:
                done = int(snap.pop("__done__"))
                state = tuple(
                    torch.from_numpy(snap[f"s{i}"]) if i == 7
                    else torch.from_numpy(snap[f"s{i}"]).to(dev)
                    for i in range(len(snap))
                )
        sig_parts, b_parts = [], []
        while done < n_iter:
            seg = int(min(chunk_size, n_iter - done))
            mu_t, b_t, tr, state = run(gens[0], iters=range(done, done + seg),
                                       state_in=state, return_state=True)
            done += seg
            sig_parts.append(tr[0])
            b_parts.append(tr[1])
            if checkpoint_path is not None:
                snap = {f"s{i}": v.cpu().numpy() for i, v in enumerate(state)}
                snap["__done__"] = np.asarray(done)
                save_state(checkpoint_path, snap)
        mus, bs_ = [mu_t], [b_t]
        sig_trace = torch.cat(sig_parts)[None]
        b_trace = torch.cat(b_parts)[None]
    else:
        outs = [run(g) for g in gens]
        mus, bs_ = [o[0] for o in outs], [o[1] for o in outs]
        sig_trace = torch.stack([o[2][0] for o in outs])
        b_trace = torch.stack([o[2][1] for o in outs])
    mu_hat = float(torch.stack(mus).mean())  # the chain's one read-back
    b_hat = torch.stack(bs_).mean(0)[:p].double().cpu().numpy()
    traces = sig_trace.double().cpu().numpy()  # (m, T)
    bt = b_trace.double().cpu().numpy()  # (m, T, 8)
    t_sweeps = time.perf_counter() - t0

    post = traces[:, n_burnin:] if traces.shape[1] > n_burnin else traces
    diag = {"sigma_e2_trace": traces[0]}
    diag.update(mcmc_diagnostics(post, name="sigma_e2"))
    bt_post = bt[:, n_burnin:, :] if bt.shape[1] > n_burnin else bt
    diag["ess_effects_mean"] = float(
        np.mean([ess(bt_post[:, :, j]) for j in range(bt_post.shape[2])])
    )
    diag["update"] = _path_name(model, bs, p_pad, group_size, pallas_groups)
    diag["stage_seconds"] = {"prep": t_prep, "sweeps": t_sweeps}
    return mu_hat, b_hat, diag


def _fold_seed(seed: int, fold: int) -> int:
    """Fold `fold`'s generator seed, from (seed, fold) alone: a fold draws the
    same numbers whatever other folds run beside it."""
    return int(np.random.SeedSequence([seed, fold]).generate_state(1, dtype=np.uint64)[0]) & (2**63 - 1)


def gibbs_cv_folds(
    X,
    y,
    fold_masks,
    model: str = "BayesC",
    n_iter: int = None,
    n_burnin: int = None,
    seed: int = 42,
    block_size: int = None,
    r2: float = 0.5,
    fix_sigma_e2: Optional[float] = None,
    fix_sigma_b2: Optional[float] = None,
    mesh=None,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Fold-batched Bayesian CV (JAX bayesian.py:1180-1334): F independent
    chains, one per {0,1} training row mask (fold_masks (F, n)), run as one
    chain with a leading fold axis on `device`.

    Each chain is the exact Gibbs sampler on its fold's training subset:
    masked rows of the fold's centered panel are zero (they contribute
    nothing to Xᵀr, the block Grams or the residual), and the entry count n
    is replaced by n_eff = Σmask in the intercept draw, the residual χ²
    degrees of freedom and the inits. On the card the indicator models run
    K3 once per block and sweep for all F folds; BL and the joint-draw
    models run their torch paths batched over the folds. Fold f draws from
    its own generator, seeded from (seed, f), so it is the chain it would be
    alone. The reference refits its sampler per fold in a Julia thread, each
    fit a fresh Rscript+BGLR subprocess (src/cross_validation.jl:159-185,
    src/bayes.jl:92-93).

    `X` is a host array or a tensor (n, p), uncentered. Hyperparameters
    (BGLR R2-based scalings) come once from the full panel and y rather than
    per fold. Gaussian responses only. Returns (mu_hat (F,), b_hat (F, p)) as
    float64 numpy.

    `mesh` (parallel/mesh.py, every rank calling with the same arguments)
    spreads the folds over the mesh's largest axis (the first on a tie; a
    ('dp', 'mp') mesh with dp = 1 must still spread them), each rank running
    its contiguous share of the folds as one fold-batched chain on its mesh
    device (K3 once per block and sweep for its folds). Dummy all-training
    folds pad F to a multiple of the axis size and are dropped; folds
    0..F-1 keep their `_fold_seed`, and every rank gates its paths on the
    whole F, so fold f gives the bits it gives without a mesh. Every rank
    returns every fold (JAX bayesian.py:1300-1330).
    """
    if model not in _MODEL_IDS:
        raise ValueError(f"unknown Bayesian model {model!r}; choose from {BAYESIAN_MODELS}")
    masks = np.asarray(fold_masks, dtype=np.float32)
    n = X.shape[0]
    if masks.ndim != 2 or masks.shape[1] != n:
        raise ValueError(f"fold_masks must be (F, n={n}); got {masks.shape}")
    if np.any(masks.sum(axis=1) < 2):
        raise ValueError("every fold needs >= 2 training rows")
    F = masks.shape[0]
    seeds = [_fold_seed(seed, f) for f in range(F)]
    if mesh is None or mesh.size == 1:
        dev = resolve_device(device) if mesh is None else mesh.device
        return _fold_chains(X, y, masks, seeds, model, n_iter, n_burnin, block_size, r2,
                            fix_sigma_e2, fix_sigma_b2, dev)[:2]
    from ..parallel.mesh import fold_share

    axis, Fp, lo, hi = fold_share(mesh, F)
    masks = np.concatenate([masks, np.ones((Fp - F, n), np.float32)])
    seeds += [_fold_seed(seed ^ 0x70AD, f) for f in range(Fp - F)]
    mu, b = _fold_chains(X, y, masks[lo:hi], seeds[lo:hi], model, n_iter, n_burnin, block_size,
                         r2, fix_sigma_e2, fix_sigma_b2, mesh.device, batch_hint=F)[:2]
    mu = mesh.allgather(torch.from_numpy(mu), axis)[:F].numpy()
    b = mesh.allgather(torch.from_numpy(b), axis)[:F].numpy()
    return mu, b


def _fold_chains(X, y, masks, seeds, model, n_iter, n_burnin, block_size, r2, fix_sigma_e2,
                 fix_sigma_b2, dev, batch_hint: Optional[int] = None):
    """`gibbs_cv_folds` past its checks: the chains of masks (F, n), fold f's
    generator seeded with seeds[f], the hoist gates counting `batch_hint`
    chains (F by default). Returns (mu (F,), b (F, p), the σ²ₑ
    trace (n_iter, F), the centered intercept's trace (n_iter, F)), float64
    numpy."""
    cfg = get_config()
    n_iter = cfg.mcmc_n_iter if n_iter is None else n_iter
    n_burnin = cfg.mcmc_n_burnin if n_burnin is None else n_burnin
    block_size = cfg.mcmc_block_size if block_size is None else block_size
    pinned = fix_sigma_e2 is not None or fix_sigma_b2 is not None
    if pinned and (fix_sigma_e2 is None or fix_sigma_b2 is None):
        raise ValueError("fix_sigma_e2 and fix_sigma_b2 must be set together")
    F, n = masks.shape
    p = X.shape[1]
    update, group_size, bs, p_pad, n_blocks = _plan(model, cfg.mcmc_indicator_update, block_size,
                                                    p, dev)
    y = np.asarray(y.cpu() if isinstance(y, torch.Tensor) else y, dtype=np.float32).reshape(-1)
    if isinstance(X, torch.Tensor):
        Xd = X.to(device=dev, dtype=torch.float32)
        ms_x = float(Xd.var(0, correction=0).sum())
    else:
        X = np.asarray(X, dtype=np.float32)
        Xd = torch.from_numpy(X).to(dev)
        ms_x = float(np.sum(np.var(X, axis=0)))
    W = torch.from_numpy(masks).to(dev)
    n_eff = W.sum(1)
    # Each fold's centered, row-masked, padded panel (JAX bayesian.py:177-188),
    # built one fold at a time so the transient stays one panel.
    Xf = torch.zeros((F, n, p_pad), dtype=torch.float32, device=dev)
    mu_cols = torch.zeros((F, p_pad), dtype=torch.float32, device=dev)
    for f in range(F):
        mu_cols[f, :p] = (W[f] @ Xd) / n_eff[f]
        Xf[f, :, :p] = (Xd - mu_cols[f, :p]) * W[f][:, None]
    panel = _setup(Xf, mu_cols, bs, n_blocks)
    valid = torch.zeros(p_pad, dtype=torch.float32, device=dev)
    valid[:p] = 1.0
    hyper = _hyper(model, float(np.var(y, ddof=1)), max(ms_x, 1e-8), p, r2, fix_sigma_e2,
                   fix_sigma_b2)
    gens = [torch.Generator(device=dev).manual_seed(s) for s in seeds]
    mu, b, (sig, _, mu_tr) = _gibbs_chain(
        panel, torch.from_numpy(y).to(dev), valid, gens, hyper, _MODEL_IDS[model], int(n_iter),
        int(n_burnin), bs, n_blocks, pinned=pinned, group_size=group_size,
        pallas_groups=update == "pallas", row_mask=W, batch_hint=batch_hint,
    )
    return (mu.double().cpu().numpy(), b[:, :p].double().cpu().numpy(),
            sig.double().cpu().numpy(), mu_tr.double().cpu().numpy())


def _hoists(model, bs, p_pad, group_size, pallas_groups, chains: int = 1) -> Tuple[bool, bool]:
    """(hoist_groups, hoist_joint): whether a sweep builds its within-block
    tables once for all blocks.

    Grouped draw: s2, σ²ₑ and π are constant across a sweep's block scan, so
    every (group, pattern) factor is built once per sweep, gated on the
    table's K² floats per pattern (no tile padding on CUDA or the host).
    Joint draw (BRR/BayesA/BayesT): the block precisions are sweep-constant
    too, so all Choleskys and inverses batch into one factorization, gated
    as in the reference on bs <= 384 and on the table's floats (the
    reference's 1e8 for one chain, `_FOLD_JOINT_TABLE_FLOATS` for several).
    `chains` fold chains hold `chains` tables: the gates count them in total, as the JAX
    gate's `batch_hint` does (bayesian.py:279-282, :298-304)."""
    indicator = model in _INDICATOR
    if group_size > 1 and (indicator or model == "BL"):
        n_pat = (1 << group_size) if indicator else 1
        fits = chains * (p_pad // group_size) * n_pat * group_size**2 <= _GROUP_TABLE_FLOATS
        return (not pallas_groups and fits), False
    joint = not indicator and model not in ("BL", "BLPi")
    budget = _JOINT_TABLE_FLOATS if chains == 1 else _FOLD_JOINT_TABLE_FLOATS
    return False, joint and bs <= 384 and chains * (p_pad // bs) * bs * bs <= budget


def _path_name(model, bs, p_pad, group_size, pallas_groups, chains: int = 1) -> str:
    """Name of the within-block path a chain runs, for the diagnostics."""
    hoist_groups, hoist_joint = _hoists(model, bs, p_pad, group_size, pallas_groups, chains)
    if group_size > 1 and (model in _INDICATOR or model == "BL"):
        return "pallas" if pallas_groups else ("grouped-hoisted" if hoist_groups else "grouped")
    if model in _INDICATOR or model in ("BL", "BLPi"):
        return "scalar"
    return "joint-hoisted" if hoist_joint else "joint"


def bglr(
    G: np.ndarray,
    y: np.ndarray,
    model: str = "BayesA",
    response_type: str = "gaussian",
    n_iter: int = None,
    n_burnin: int = None,
    seed: int = 42,
    verbose: bool = False,
    device="cuda",
) -> np.ndarray:
    """Low-level sampler entry point, name/shape-compatible with the
    reference's `bglr` (src/bayes.jl:28-105): takes a marker matrix G and
    response y, returns b_hat = [mu; marker effects]. The reference shells
    out to Rscript+BGLR; this runs the blocked Gibbs sampler on `device`."""
    mu_hat, b_marker, _ = gibbs_regression(
        np.asarray(G, dtype=np.float64), np.asarray(y, dtype=np.float64),
        model=model, n_iter=n_iter, n_burnin=n_burnin, seed=seed,
        response_type=response_type, device=device,
    )
    return np.concatenate([[mu_hat], b_marker])


def bayesian(
    bglr_model: str,
    genomes: Genomes,
    phenomes: Phenomes,
    idx_entries: Optional[Sequence[int]] = None,
    idx_loci_alleles: Optional[Sequence[int]] = None,
    idx_trait: int = 0,
    response_type: str = "gaussian",
    n_burnin: int = None,
    n_iter: int = None,
    seed: int = 42,
    n_chains: int = 1,
    verbose: bool = False,
    device="cuda",
) -> Fit:
    """Fit a Bayesian-alphabet model (reference `bayesian`, src/bayes.jl:161-228)
    with the blocked Gibbs sampler on `device`. `response_type="ordinal"`
    runs the Albert-Chib probit sampler (predictions are latent liabilities).
    `fit.extras` names the within-block path run (`update`) and holds the
    wall seconds of the prep and the sweeps (`stage_seconds`).
    """
    X, y, entries, populations, loci_alleles = extractxyetc(
        genomes, phenomes, idx_entries=idx_entries, idx_loci_alleles=idx_loci_alleles,
        idx_trait=idx_trait, add_intercept=True,
    )
    G = X[:, 1:]
    mu_hat, b_marker, diag = gibbs_regression(
        G, y, model=bglr_model, n_iter=n_iter, n_burnin=n_burnin, seed=seed, n_chains=n_chains,
        response_type=response_type, device=device,
    )
    b_hat = np.concatenate([[mu_hat], b_marker])
    y_pred = X @ b_hat
    fit = Fit(
        model=bglr_model,
        b_hat=b_hat,
        b_hat_labels=np.concatenate([np.asarray(["intercept"], dtype=object), loci_alleles]),
        trait=str(phenomes.traits[idx_trait]),
        entries=entries,
        populations=populations,
        y_true=y,
        y_pred=y_pred,
        metrics=metrics(y, y_pred),
        extras={"update": diag["update"], "stage_seconds": diag["stage_seconds"]},
    )
    if not fit.checkdims():
        raise RuntimeError(f"error fitting {bglr_model}")
    return fit


def _alphabet(model_key: str, public_name: str):
    def f(
        genomes: Genomes,
        phenomes: Phenomes,
        idx_entries=None,
        idx_loci_alleles=None,
        idx_trait: int = 0,
        n_iter: int = None,
        n_burnin: int = None,
        seed: int = 42,
        n_chains: int = 1,
        verbose: bool = False,
        device="cuda",
    ) -> Fit:
        fit = bayesian(
            model_key,
            genomes=genomes,
            phenomes=phenomes,
            idx_entries=idx_entries,
            idx_loci_alleles=idx_loci_alleles,
            idx_trait=idx_trait,
            n_iter=n_iter,
            n_burnin=n_burnin,
            seed=seed,
            n_chains=n_chains,
            verbose=verbose,
            device=device,
        )
        fit.model = public_name
        return fit

    f.__name__ = public_name
    f.__qualname__ = public_name
    f.__doc__ = (
        f"Fit {model_key} via the blocked Gibbs sampler on `device` "
        f"(reference wrapper at src/linear.jl:440-626)."
    )
    return f


bayesa = _alphabet("BayesA", "bayesa")
bayesb = _alphabet("BayesB", "bayesb")
bayesc = _alphabet("BayesC", "bayesc")
bayesian_ridge = _alphabet("BRR", "bayesian_ridge")
bayesian_lasso = _alphabet("BL", "bayesian_lasso")
# The reference documents (as commented-out Turing models, src/bayes.jl:
# 510-855) Laplace and t priors each with an optional point mass at zero.
bayesian_lasso_pi = _alphabet("BLPi", "bayesian_lasso_pi")
bayest = _alphabet("BayesT", "bayest")
bayestpi = _alphabet("BayesTPi", "bayestpi")
