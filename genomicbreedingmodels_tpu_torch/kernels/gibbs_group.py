"""K3: one marker block's grouped 2^K-pattern collapsed Gibbs draw.

Port of genomicbreedingmodels_tpu/ops/pallas_gibbs.py (`grouped_block_update`
→ `_kernel`), the within-block update of the indicator models (BayesB/C,
BLπ, BayesTπ). For each of the G = bs/K marker groups in sequence it scores
all 2^K inclusion patterns γ with the collapsed (effect-integrated) marginal
likelihood, samples the pattern by Gumbel-max, draws the included effects
jointly from their K-dim Gaussian conditional, and folds the change into the
correlation of the later groups (exact partially-collapsed blocked Gibbs).

- `grouped_block_update` keeps the JAX signature and contract, and also
  takes a leading fold axis: F independent chains (the row-masked fold
  chains of cross-validation) update their block `blk` in one launch. A CUDA
  tensor goes to the hand-written kernel `csrc/gibbs_group.cu`, one launch
  on the current stream for up to `folds_per_launch` folds (half the SMs, so
  the scan CTAs, which wait on builders, can never fill a card that runs
  one K3 launch at a time), and
  `LAUNCHES["gibbs_group"]` goes up by one per launch; a failed build or
  launch raises. A CPU tensor goes to the plain version. The kernel takes
  1 <= K <= 8 and bs <= MAX_BS (the running correlation lives in shared
  memory); the wrapper raises beyond, on every device.
- The kernel's builder CTAs write every group's pattern tables into a
  workspace that the wrapper keeps per device and stream (`_workspace`,
  grown from PyTorch's allocator, never freed, taken with its epoch under
  `_build.LAUNCH_LOCK` since host threads share a stream), each builder CTA publishes
  one ready flag for its groups, and the scan CTA reads a group's tables
  once that flag carries this launch's epoch (`next_epoch`).
  `k3_layout` gives the workspace's and the shared memory's geometry.
- `grouped_block_update_plain` is the same law in torch: the block's 2^K
  pattern factors are built batched (`group_tables`), then a loop over the
  groups scores, selects and draws (`group_scan`), every fold at once. The
  Gibbs chain's in-step "grouped" path calls it directly on any device, and
  its sweep-hoisted path calls `group_tables`/`group_scan` on a sweep's
  tables. Every operation of the fold-batched plain version acts on each
  fold alone, so fold f of a batch gives the numbers of fold f run alone.

The noise (normals η and Gumbel draws) comes from the caller, so both
versions are deterministic functions of their inputs and the tests feed them
the same numbers.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import torch

from . import _build
from ._build import LAUNCH_LOCK, LAUNCHES

__all__ = [
    "LAUNCHES",
    "MAX_BS",
    "MAX_K",
    "group_scan",
    "group_tables",
    "grouped_block_update",
    "grouped_block_update_plain",
    "folds_per_launch",
    "k3_layout",
    "next_epoch",
    "pattern_bits",
]

MAX_K = 8  # 2^8 = 256 patterns: one builder thread each, 8 per scan lane
MAX_BS = 8192  # the running correlation w = u − cdelta: bs floats of shared memory

# The kernel's geometry (csrc/gibbs_group.cu): CTAs of 256 threads; a ring of
# 3 table slices and Cb row stages; at most 227 KB of shared memory per CTA.
_NT, _STAGES, _SMEM_MAX = 256, 3, 232_448
_EPOCH_MAX = 2**31 - 1  # the flags are int32


@dataclass(frozen=True)
class K3Layout:
    groups: int  # G = bs / K
    slice_floats: int  # one group's table slice, a multiple of 4 floats (16 bytes)
    quads: int  # column quads of a Cb row, ceil(bs / 4)
    staged_quads: int  # the first quads, staged in shared memory; the rest are read from L2
    builders: int  # builder CTAs beside the scan CTA, one ready flag each
    smem_bytes: int  # dynamic shared memory of each CTA

    @property
    def table_floats(self) -> int:
        return self.groups * self.slice_floats


@lru_cache(maxsize=64)  # the chain asks once per block, with one or two (bs, K)
def k3_layout(bs: int, K: int) -> K3Layout:
    """The kernel's workspace and shared-memory geometry at (bs, K).

    A group's slice holds W̃'s K(K+1)/2 lower entries and the constant
    log-weight of each of the 2^K patterns, then C_gg·b_g, the K×K block
    linking it to the group before, b_g, η_g and the validity mask. Shared
    memory holds the ring of slices, the staged quads of the K Cb rows per
    stage, w (padded to whole quads) and the last two groups' (d, b_new,
    incl). Every quad
    is staged where they fit (up to bs ≈ 1024 at K=8); beyond, the first
    `staged_quads` are, and the update reads the rest from L2."""
    G, npat = bs // K, 1 << K
    used = npat * (K * (K + 1) // 2 + 1) + K * K + 4 * K
    slice_floats = -(-used // 4) * 4
    quads = -(-bs // 4)
    fixed = 4 * (8 + _STAGES * slice_floats + 4 * quads + 6 * K)  # 8: the ring's mbarriers
    staged = min(quads, (_SMEM_MAX - fixed) // (16 * _STAGES * K))
    if staged < 0:
        raise ValueError(f"grouped_block_update: bs={bs}, K={K} does not fit shared memory")
    gpc = max(1, _NT // npat)
    return K3Layout(G, slice_floats, quads, staged, -(-G // gpc),
                    fixed + 16 * _STAGES * K * staged)


def next_epoch(epoch: int) -> int:
    """The epoch of the next launch on a workspace: 1, 2, ..., 2³¹−1, 1, ...
    Never 0, the value of a fresh flag."""
    return epoch % _EPOCH_MAX + 1


def folds_per_launch(n_sms: int) -> int:
    """The most folds one launch takes on a card of `n_sms` SMs: half of
    them. Only scan CTAs wait (on builders of their own fold, which never
    wait), so with at most one scan per two SMs a builder always finds a
    CTA slot, whatever order the CTAs are dispatched in, provided no other
    K3 launch or other tenant holds SMs at the same time: the port launches
    K3 on one stream, one launch after another. Concurrent fold launches on
    two streams could fill the card with waiting scans; their wait then
    traps (csrc/gibbs_group.cu, WAIT_TRAP_CYCLES) and the next
    synchronization raises, instead of hanging."""
    return max(1, n_sms // 2)


@lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


# (device, stream) -> [tables (float32), flags (int32), epoch of the last launch]
_WORKSPACES: dict = {}


def _workspace(dev: torch.device, stream: int, layout: K3Layout, folds: int = 1):
    """This (device, stream)'s workspace, grown to `folds` × `layout`, and
    the epoch of the launch about to use it. Launches on one stream run in
    order, so one stream's launches never race on it; each stream has its
    own. One epoch serves every fold's flags of the launch.

    Host threads share a stream (every thread's default stream is the same
    one), so the lookup, the growth and the epoch bump are one critical
    section under `LAUNCH_LOCK`: two launches never get one epoch, which
    would let the second one's scan read the first one's tables as ready."""
    with LAUNCH_LOCK:
        ws = _WORKSPACES.get((dev, stream))
        need_t, need_f = folds * layout.table_floats, folds * layout.builders
        if ws is None or ws[0].numel() < need_t or ws[1].numel() < need_f:
            ws = [torch.empty(need_t, dtype=torch.float32, device=dev),
                  torch.zeros(need_f, dtype=torch.int32, device=dev), 0]
            _WORKSPACES[(dev, stream)] = ws
        ws[2] = next_epoch(ws[2])
        return ws[0], ws[1], ws[2]


def pattern_bits(K: int, device=None, indicator: bool = True) -> torch.Tensor:
    """(2^K, K) float32 inclusion patterns, bit k of pattern m is γ_mk; the
    single all-ones pattern when `indicator` is False (BL's degenerate case)."""
    if not indicator:
        return torch.ones((1, K), dtype=torch.float32, device=device)
    m = torch.arange(1 << K, device=device)
    return ((m[:, None] >> torch.arange(K, device=device)[None, :]) & 1).to(torch.float32)


def group_tables(C_gg, s2g, valg, patterns, sig_e2, pi_in):
    """(W̃, const) of every group and pattern, batched over leading dims.

    C_gg (..., K, K) diagonal Gram blocks, s2g/valg (..., K), patterns
    (P, K), sig_e2/pi_in tensors that broadcast against the leading dims
    (0-d for one chain, (F, 1) for C_gg (F, G, K, K)). With P(γ) = (C_gg∘γγᵀ)/σ²ₑ +
    diag(γ/s² + 1−γ) = L·Lᵀ (the reference's clamped elimination, unrolled
    over K), W̃ (..., P, K, K) is L⁻¹ with rows and columns zeroed at
    excluded coordinates, and const (..., P) is the residual-independent part
    of the pattern log-weight: Σγ·logπ + Σ(1−γ)·log(1−π) − ½Σ_γ log s² −
    ½log|P| − 1e30·(γ on invalid markers). With Z = W̃v the score is
    const + ½‖Z‖² and the selected pattern's draw is b = W̃ᵀ(Z + η).
    """
    K = C_gg.shape[-1]
    M = patterns * valg[..., None, :]  # (..., P, K)
    MM = M[..., :, None] * M[..., None, :]
    diag = torch.where(M > 0, 1.0 / torch.clamp(s2g, min=1e-12)[..., None, :], 1.0)
    acc = (C_gg / sig_e2[..., None, None])[..., None, :, :] * MM + torch.diag_embed(diag)
    # Clamped Cholesky, column by column; only the trailing block is updated.
    L = torch.zeros_like(acc)
    half_logdet = torch.zeros(acc.shape[:-2], dtype=acc.dtype, device=acc.device)
    for j in range(K):
        dj = torch.clamp(acc[..., j, j], min=1e-30)
        half_logdet.add_(torch.log(dj), alpha=0.5)
        col = acc[..., j:, j] * torch.rsqrt(dj)[..., None]
        L[..., j:, j] = col
        acc[..., j + 1 :, j + 1 :] -= col[..., 1:, None] * col[..., None, 1:]
    # W = L⁻¹ by row-wise forward substitution, masked to the pattern.
    W = torch.zeros_like(acc)
    eye = torch.eye(K, dtype=acc.dtype, device=acc.device)
    for i in range(K):
        row = eye[i] - (L[..., i, :i, None] * W[..., :i, :]).sum(-2)
        W[..., i, :] = row / L[..., i, i, None]
    W.mul_(MM)
    log_pi = torch.log(pi_in)[..., None]
    log_1mpi = torch.log1p(-torch.clamp(pi_in, max=1.0 - 1e-7))[..., None]
    val_e = valg[..., None, :]
    const = (
        M.sum(-1) * log_pi
        + (val_e * (1.0 - patterns)).sum(-1) * log_1mpi
        - 0.5 * torch.where(M > 0, torch.log(s2g)[..., None, :], 0.0).sum(-1)
        - half_logdet
        - 1e30 * (patterns * (1.0 - val_e)).sum(-1)
    )
    return W, const


def group_scan(W, const, gum, Cb, u, b_blk, normals, sig_e2, patterns, val_blk):
    """The sequential group loop of one block of F fold chains, given its tables.

    W (F, G, P, K, K) and const (F, G, P) from `group_tables`; gum (F, G, P)
    Gumbel noise or None (single pattern); Cb (F, bs, bs); u = X_bᵀr,
    b_blk, normals (F, bs); sig_e2 (F,); val_blk (bs,), shared. Returns
    (delta, b_new, incl), each (F, bs). Without the fold axis (W (G, P, K,
    K), ..., sig_e2 0-d) it is one chain's loop, and the outputs are (bs,).

    Carried: vb = (u − cdelta + C_gg·b_blk)/σ²ₑ for every marker. A group's
    own effects are untouched until its step, so C_gg·b_blk is taken once
    for the block, and each step subtracts its change d from the later
    groups through the K rows of Cb/σ²ₑ (one batched product). The single
    pattern (BL) has no choice to make, so its loop is one triangular
    solve (`_single_pattern_block`).
    """
    one = W.dim() == 4
    if one:
        W, const, gum, Cb = W[None], const[None], _folded(gum, 2), Cb[None]
        u, b_blk, normals = u[None], b_blk[None], normals[None]
    sig_e2 = sig_e2.reshape(-1)
    F, G, P, K, _ = W.shape
    bs = G * K
    if P == 1:
        b_new = _single_pattern_block(W[:, :, 0], Cb, u, b_blk, normals, sig_e2)
        out = (b_new - b_blk, b_new, (patterns * val_blk.view(G, K)).reshape(1, bs).expand(F, bs))
        return tuple(o[0] for o in out) if one else out
    Cgg = Cb.view(F, G, K, G, K).diagonal(dim1=1, dim2=3).permute(0, 3, 1, 2)  # (F, G, K, K)
    b_g = b_blk.reshape(F, G, K)
    vb = (u + (Cgg @ b_g[..., None]).reshape(F, bs)) / sig_e2[:, None]
    base = const if gum is None else const + gum
    # Per-group views, taken once: the loop body is launch-bound, so it
    # issues as few operations as it can (the v views follow vb's updates).
    v_g, W_g, base_g = vb.view(F, G, K, 1).unbind(1), W.unbind(1), base.unbind(1)
    eta_g, b_old = normals.reshape(F, G, K).unbind(1), b_g.unbind(1)
    rows = (Cb / sig_e2[:, None, None]).view(F, G, K, bs).unbind(1)  # (F, K, bs)
    vb_row = vb[:, None, :]
    folds = torch.arange(F, device=W.device)
    new, picks = [], []
    for g in range(G):
        Z = (W_g[g] @ v_g[g][:, None]).squeeze(-1)  # (F, P, K) = L⁻¹v per pattern
        m = torch.argmax(torch.add(base_g[g], torch.linalg.vecdot(Z, Z), alpha=0.5), 1)
        Ws = W_g[g][folds, m]  # (F, K, K)
        z = torch.baddbmm(eta_g[g][..., None], Ws, v_g[g])  # W̃v + η
        b_new = (Ws.transpose(1, 2) @ z).squeeze(-1)  # W̃ᵀ(W̃v + η)
        # a row vector times the K rows: each fold rounds alike whatever F is
        vb_row.baddbmm_((b_new - b_old[g])[:, None, :], rows[g], alpha=-1.0)
        new.append(b_new)
        picks.append(m)
    b_new = torch.cat(new, 1)
    incl = (patterns[torch.stack(picks, 1)] * val_blk.view(G, K)).reshape(F, bs)
    out = (b_new - b_blk, b_new, incl)
    return tuple(o[0] for o in out) if one else out


def _single_pattern_block(W, Cb, u, b_blk, normals, sig_e2):
    """The group loop of the single all-ones pattern (BL) as one solve.

    W (F, G, K, K) is each group's masked L⁻¹. Group g draws
    b_g = A_g·v_g + e_g with A_g = W̃ᵀW̃ = P_g⁻¹ and e_g = W̃ᵀη_g, where
    v_g = w_g − Σ_{h<g} (C_gh/σ²ₑ)·b_h (new effects) and w = (u + C_≤·b)/σ²ₑ
    (old effects, C_≤ the block-lower part of Cb including the diagonal
    blocks). So the block's new effects solve (I + diag(A)·C_<) b = diag(A)·w
    + e, with C_< the strictly block-lower part of Cb/σ²ₑ: a unit lower
    triangular system, the same law as the loop in one triangular solve.
    Every product is an elementwise product summed over K, so each fold
    rounds alike whatever F is. Returns b_new (F, bs)."""
    F, G, K, _ = W.shape
    bs = G * K
    grp = torch.arange(bs, device=W.device) // K
    Cs = (Cb / sig_e2[:, None, None]).view(F, G, K, bs)
    below = grp[None, None, :] < torch.arange(G, device=W.device)[:, None, None]  # (G, 1, bs)
    C_lt = torch.where(below, Cs, 0.0)  # strictly block-lower rows of each group
    C_le = torch.where(grp[None, None, :] <= torch.arange(G, device=W.device)[:, None, None], Cs, 0.0)
    w = u.view(F, G, K) / sig_e2[:, None, None] + (C_le * b_blk.reshape(F, 1, 1, bs)).sum(-1)
    A = (W[..., :, :, None] * W[..., :, None, :]).sum(-3)  # (F, G, K, K) = W̃ᵀW̃
    e = (W * normals.reshape(F, G, K, 1)).sum(-2)  # W̃ᵀη
    rhs = (A * w[:, :, None, :]).sum(-1) + e  # (F, G, K)
    T = (A[..., None] * C_lt[:, :, None, :, :]).sum(-2).reshape(F, bs, bs)  # diag(A)·C_<
    return torch.linalg.solve_triangular(T, rhs.reshape(F, bs, 1), upper=False,
                                         unitriangular=True)[..., 0]


def _folded(t, dims: int):
    """`t` with a leading fold axis of 1 if it has only `dims` dims."""
    return t if t is None or t.dim() > dims else t[None]


def grouped_block_update_plain(Cb, u, b_blk, s2_blk, val_blk, normals, gum, sig_e2, pi_in, K: int,
                               patterns=None):
    """K3's plain version: the same update law in torch, on any device.

    Unbatched (Cb (bs, bs), vectors (bs,), gum (bs/K, 2^K), sig_e2 and pi_in
    0-d) or with a leading fold axis on everything but val_blk (Cb (F, bs,
    bs), vectors (F, bs), gum (F, bs/K, 2^K), sig_e2 and pi_in (F,)); the
    outputs follow. `patterns` defaults to all 2^K inclusion patterns; the
    chain passes BL's single all-ones pattern (with gum=None) through the
    same code."""
    one = Cb.dim() == 2
    Cb, gum = _folded(Cb, 2), _folded(gum, 2)
    u, b_blk, s2_blk, normals = (_folded(t, 1) for t in (u, b_blk, s2_blk, normals))
    sig_e2, pi_in = sig_e2.reshape(-1), pi_in.reshape(-1)
    F, bs = u.shape
    G = bs // K
    if patterns is None:
        patterns = pattern_bits(K, Cb.device)
    Cgg = Cb.view(F, G, K, G, K).diagonal(dim1=1, dim2=3).permute(0, 3, 1, 2)
    W, const = group_tables(Cgg, s2_blk.reshape(F, G, K), val_blk.view(G, K), patterns,
                            sig_e2[:, None], pi_in[:, None])
    out = group_scan(W, const, gum, Cb, u, b_blk, normals, sig_e2, patterns, val_blk)
    return tuple(o[0] for o in out) if one else out


def _check(name, t, shape, device, folded=False):
    """`t` is a float32 tensor of `shape` on `device`, contiguous, or with
    `folded` contiguous within each fold (every dim but the leading fold
    axis; the fold stride is free)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"grouped_block_update: {name} wants a torch.Tensor, got {type(t).__name__}")
    if t.dtype != torch.float32:
        raise TypeError(f"grouped_block_update: {name} wants float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"grouped_block_update: {name} wants shape {shape}, got {tuple(t.shape)}")
    if not (t[0] if folded and t.shape[0] else t).is_contiguous():
        raise ValueError(f"grouped_block_update: {name} must be contiguous (within each fold)")
    if t.device != device:
        raise ValueError(f"grouped_block_update: {name} is on {t.device}, Cb on {device}")


def grouped_block_update(Cb, u, b_blk, s2_blk, val_blk, normals, gum, sig_e2, pi_in, K: int = 8):
    """K3: one grouped indicator block update, of one chain or of F fold chains.

    Cb (bs, bs) block Gram X_bᵀX_b; u = X_bᵀr at block start; b_blk,
    s2_blk, val_blk, normals (bs,): current effects, per-marker prior
    variances, validity mask, pre-drawn N(0, 1); gum (bs/K, 2^K) pre-drawn
    Gumbel noise; sig_e2, pi_in 0-d tensors on Cb's device (residual
    variance, inclusion probability). All float32 and contiguous.

    With a fold axis: Cb (F, bs, bs), u, b_blk, s2_blk, normals (F, bs), gum
    (F, bs/K, 2^K), sig_e2 and pi_in (F,); val_blk stays (bs,), shared. Each
    fold may sit at any stride (b[:, sl] of an (F, p) state is taken as it
    is) but must be contiguous within itself.

    Returns (delta, b_new, incl), each (bs,) or (F, bs) float32.
    """
    if not 1 <= K <= MAX_K:
        raise ValueError(f"grouped_block_update: the kernel takes 1 <= K <= {MAX_K}, got K={K}")
    if not isinstance(Cb, torch.Tensor) or Cb.dim() not in (2, 3):
        raise ValueError("grouped_block_update: Cb wants a (bs, bs) or (F, bs, bs) tensor")
    one = Cb.dim() == 2
    F, bs = (1, Cb.shape[0]) if one else Cb.shape[:2]
    if bs % K or bs == 0:
        raise ValueError(f"grouped_block_update: bs={bs} must be a positive multiple of K={K}")
    if bs > MAX_BS:
        raise ValueError(
            f"grouped_block_update: bs={bs} does not fit the kernel's shared memory "
            f"(at most {MAX_BS} markers per block)"
        )
    dev = Cb.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"grouped_block_update runs on cpu or cuda tensors, got {dev}")
    lead = () if one else (F,)
    _check("Cb", Cb, lead + (bs, bs), dev, not one)
    for name, t in (("u", u), ("b_blk", b_blk), ("s2_blk", s2_blk), ("normals", normals)):
        _check(name, t, lead + (bs,), dev, not one)
    _check("val_blk", val_blk, (bs,), dev)
    _check("gum", gum, lead + (bs // K, 1 << K), dev, not one)
    for name, t in (("sig_e2", sig_e2), ("pi_in", pi_in)):
        if one and isinstance(t, torch.Tensor) and t.numel() == 1:
            t = t.reshape(())
        _check(name, t, lead, dev)
    if dev.type == "cpu":
        return grouped_block_update_plain(Cb, u, b_blk, s2_blk, val_blk, normals, gum,
                                          sig_e2, pi_in, K)
    delta = torch.empty(lead + (bs,), dtype=torch.float32, device=dev)
    b_new = torch.empty_like(delta)
    incl = torch.empty_like(delta)
    layout = k3_layout(bs, K)
    if one:
        fs = (0,) * 6
        chunks = [(0, 1)]
    else:
        fs = tuple(t.stride(0) for t in (Cb, u, b_blk, s2_blk, normals, gum))
        cap = folds_per_launch(_sm_count(dev))
        chunks = [(f0, min(F, f0 + cap)) for f0 in range(0, F, cap)]
    ins = (Cb, u, b_blk, s2_blk, normals, gum)
    for f0, f1 in chunks:
        # fold f0's pointers: the kernel steps each input by its fold stride
        p = [t.data_ptr() + 4 * f0 * st for t, st in zip(ins, fs)]
        out = [t.data_ptr() + 4 * f0 * bs for t in (delta, b_new, incl)]
        # One critical section from the workspace lookup to the count: a
        # stream's launches then also enqueue in the order of their epochs.
        with torch.cuda.device(dev), LAUNCH_LOCK:
            stream = torch.cuda.current_stream(dev).cuda_stream
            tables, flags, epoch = _workspace(dev, stream, layout, f1 - f0)
            _build.launch(
                "gbm_gibbs_group",
                p[0], p[1], p[2], p[3], val_blk.data_ptr(), p[4], p[5],
                sig_e2.data_ptr() + 4 * f0, pi_in.data_ptr() + 4 * f0, *out,
                bs, K, tables.data_ptr(), flags.data_ptr(), epoch, layout.slice_floats,
                layout.staged_quads, f1 - f0, *fs, stream,
            )
            _build.count_launch("gibbs_group", (f1 - f0, bs, K))
    return delta, b_new, incl
