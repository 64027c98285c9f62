"""K3: one marker block's grouped 2^K-pattern collapsed Gibbs draw.

Port of genomicbreedingmodels_tpu/ops/pallas_gibbs.py (`grouped_block_update`
→ `_kernel`), the within-block update of the indicator models (BayesB/C,
BLπ, BayesTπ). For each of the G = bs/K marker groups in sequence it scores
all 2^K inclusion patterns γ with the collapsed (effect-integrated) marginal
likelihood, samples the pattern by Gumbel-max, draws the included effects
jointly from their K-dim Gaussian conditional, and folds the change into the
correlation of the later groups (exact partially-collapsed blocked Gibbs).

- `grouped_block_update` keeps the JAX signature and contract. A CUDA tensor
  goes to the hand-written kernel `csrc/gibbs_group.cu`, one launch on the
  current stream, and `LAUNCHES["gibbs_group"]` goes up by one; a failed
  build or launch raises. A CPU tensor goes to the plain version. The
  kernel takes 1 <= K <= 8 and bs <= MAX_BS (the running correlation lives
  in shared memory); the wrapper raises beyond, on every device.
- The kernel's builder CTAs write every group's pattern tables into a
  workspace that the wrapper keeps per device and stream (`_workspace`,
  grown from PyTorch's allocator, never freed, taken with its epoch under
  `_build.LAUNCH_LOCK` since host threads share a stream), each builder CTA publishes
  one ready flag for its groups, and the scan CTA reads a group's tables
  once that flag carries this launch's epoch (`next_epoch`).
  `k3_layout` gives the workspace's and the shared memory's geometry.
- `grouped_block_update_plain` is the same law in torch: the block's 2^K
  pattern factors are built batched (`group_tables`), then a loop over the
  groups scores, selects and draws (`group_scan`). The Gibbs chain's
  in-step "grouped" path calls it directly on any device, and its
  sweep-hoisted path calls `group_tables`/`group_scan` on a sweep's tables.

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


# (device, stream) -> [tables (float32), flags (int32), epoch of the last launch]
_WORKSPACES: dict = {}


def _workspace(dev: torch.device, stream: int, layout: K3Layout):
    """This (device, stream)'s workspace, grown to `layout`, and the epoch of
    the launch about to use it. Launches on one stream run in order, so one
    stream's launches never race on it; each stream has its own.

    Host threads share a stream (every thread's default stream is the same
    one), so the lookup, the growth and the epoch bump are one critical
    section under `LAUNCH_LOCK`: two launches never get one epoch, which
    would let the second one's scan read the first one's tables as ready."""
    with LAUNCH_LOCK:
        ws = _WORKSPACES.get((dev, stream))
        if ws is None or ws[0].numel() < layout.table_floats or ws[1].numel() < layout.builders:
            ws = [torch.empty(layout.table_floats, dtype=torch.float32, device=dev),
                  torch.zeros(layout.builders, dtype=torch.int32, device=dev), 0]
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
    (P, K), sig_e2/pi_in 0-d tensors. With P(γ) = (C_gg∘γγᵀ)/σ²ₑ +
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
    acc = (C_gg / sig_e2)[..., None, :, :] * MM + torch.diag_embed(diag)
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
    log_pi = torch.log(pi_in)
    log_1mpi = torch.log1p(-torch.clamp(pi_in, max=1.0 - 1e-7))
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
    """The sequential group loop of one block, given its tables.

    W (G, P, K, K) and const (G, P) from `group_tables`; gum (G, P) Gumbel
    noise or None (single pattern); Cb (bs, bs); u = X_bᵀr, b_blk, normals,
    val_blk (bs,). Returns (delta, b_new, incl), each (bs,).

    Carried: vb = (u − cdelta + C_gg·b_blk)/σ²ₑ for every marker. A group's
    own effects are untouched until its step, so C_gg·b_blk is taken once
    for the block, and each step subtracts its change d from the later
    groups through the K rows of Cb/σ²ₑ (one addmv).
    """
    G, P, K, _ = W.shape
    bs = G * K
    Cgg = Cb.view(G, K, G, K).diagonal(dim1=0, dim2=2).permute(2, 0, 1)  # (G, K, K)
    b_g = b_blk.view(G, K)
    vb = (u + torch.bmm(Cgg, b_g[:, :, None]).reshape(bs)) / sig_e2
    base = const if gum is None else const + gum
    # Per-group views, taken once: the loop body is launch-bound, so it
    # issues as few operations as it can (the v views follow vb's updates).
    v_g, W_g, base_g = vb.view(G, K).unbind(), W.unbind(), base.unbind()
    eta_g, b_old = normals.view(G, K).unbind(), b_g.unbind()
    rows_T = (Cb / sig_e2).view(G, K, bs).transpose(1, 2).unbind()  # (bs, K) each
    new, picks = [], []
    for g in range(G):
        Z = W_g[g] @ v_g[g]  # (P, K) = L⁻¹v per pattern
        m = torch.argmax(torch.add(base_g[g], torch.linalg.vecdot(Z, Z), alpha=0.5), 0, True)
        Ws = W_g[g].index_select(0, m).view(K, K)
        b_new = torch.addmv(eta_g[g], Ws, v_g[g]) @ Ws  # W̃ᵀ(W̃v + η)
        vb.addmv_(rows_T[g], b_new - b_old[g], alpha=-1.0)
        new.append(b_new)
        picks.append(m)
    b_new = torch.cat(new)
    incl = (patterns.index_select(0, torch.cat(picks)) * val_blk.view(G, K)).reshape(bs)
    return b_new - b_blk, b_new, incl


def grouped_block_update_plain(Cb, u, b_blk, s2_blk, val_blk, normals, gum, sig_e2, pi_in, K: int,
                               patterns=None):
    """K3's plain version: the same update law in torch, on any device.
    `patterns` defaults to all 2^K inclusion patterns; the chain passes BL's
    single all-ones pattern (with gum=None) through the same code."""
    bs = Cb.shape[0]
    G = bs // K
    if patterns is None:
        patterns = pattern_bits(K, Cb.device)
    Cgg = Cb.view(G, K, G, K).diagonal(dim1=0, dim2=2).permute(2, 0, 1)
    W, const = group_tables(Cgg, s2_blk.view(G, K), val_blk.view(G, K), patterns, sig_e2, pi_in)
    return group_scan(W, const, gum, Cb, u, b_blk, normals, sig_e2, patterns, val_blk)


def _check(name, t, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"grouped_block_update: {name} wants a torch.Tensor, got {type(t).__name__}")
    if t.dtype != torch.float32:
        raise TypeError(f"grouped_block_update: {name} wants float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"grouped_block_update: {name} wants shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"grouped_block_update: {name} must be contiguous")
    if t.device != device:
        raise ValueError(f"grouped_block_update: {name} is on {t.device}, Cb on {device}")


def grouped_block_update(Cb, u, b_blk, s2_blk, val_blk, normals, gum, sig_e2, pi_in, K: int = 8):
    """K3: one grouped indicator block update.

    Cb (bs, bs) block Gram X_bᵀX_b; u = X_bᵀr at block start; b_blk,
    s2_blk, val_blk, normals (bs,): current effects, per-marker prior
    variances, validity mask, pre-drawn N(0, 1); gum (bs/K, 2^K) pre-drawn
    Gumbel noise; sig_e2, pi_in 0-d tensors on Cb's device (residual
    variance, inclusion probability). All float32 and contiguous.

    Returns (delta, b_new, incl), each (bs,) float32.
    """
    if not 1 <= K <= MAX_K:
        raise ValueError(f"grouped_block_update: the kernel takes 1 <= K <= {MAX_K}, got K={K}")
    if not isinstance(Cb, torch.Tensor) or Cb.dim() != 2:
        raise ValueError("grouped_block_update: Cb wants a 2-D (bs, bs) tensor")
    bs = Cb.shape[0]
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
    _check("Cb", Cb, (bs, bs), dev)
    for name, t in (("u", u), ("b_blk", b_blk), ("s2_blk", s2_blk), ("val_blk", val_blk),
                    ("normals", normals)):
        _check(name, t, (bs,), dev)
    _check("gum", gum, (bs // K, 1 << K), dev)
    for name, t in (("sig_e2", sig_e2), ("pi_in", pi_in)):
        _check(name, t.reshape(()) if isinstance(t, torch.Tensor) and t.numel() == 1 else t, (), dev)
    if dev.type == "cpu":
        return grouped_block_update_plain(Cb, u, b_blk, s2_blk, val_blk, normals, gum,
                                          sig_e2, pi_in, K)
    delta = torch.empty(bs, dtype=torch.float32, device=dev)
    b_new = torch.empty_like(delta)
    incl = torch.empty_like(delta)
    layout = k3_layout(bs, K)
    # One critical section from the workspace lookup to the count: a
    # stream's launches then also enqueue in the order of their epochs.
    with torch.cuda.device(dev), LAUNCH_LOCK:
        stream = torch.cuda.current_stream(dev).cuda_stream
        tables, flags, epoch = _workspace(dev, stream, layout)
        _build.launch(
            "gbm_gibbs_group",
            Cb.data_ptr(), u.data_ptr(), b_blk.data_ptr(), s2_blk.data_ptr(),
            val_blk.data_ptr(), normals.data_ptr(), gum.data_ptr(), sig_e2.data_ptr(),
            pi_in.data_ptr(), delta.data_ptr(), b_new.data_ptr(), incl.data_ptr(),
            bs, K, tables.data_ptr(), flags.data_ptr(), epoch, layout.slice_floats,
            layout.staged_quads, stream,
        )
        _build.count_launch("gibbs_group")
    return delta, b_new, incl
