"""Triangular raw Gram kernels K1 (int8 dosages) and K2 (f32/bf16 panels).

Port of genomicbreedingmodels_tpu/ops/pallas_kernels.py: `gram_tri_kernel_int8`
(K1) and `gram_tri_kernel` (K2). Both compute only the lower-triangular output
tiles of the raw Gram X·Xᵀ of an (n, p) entry-major panel; centering and
scaling stay outside, in ops/grm.py.

Contract of both wrappers: the result is (n, n) with the lower triangle
(diagonal included) holding X·Xᵀ and the strict upper triangle exactly zero.

- A CUDA tensor goes to the hand-written Hopper kernel in `csrc/` (built by
  nvcc at first use, see `_build.py`), launched on the current stream, and
  the kernel's entry in `LAUNCHES` goes up by one (`_build.count_launch`,
  which also records the panel's dtype and shape).
  A failed build or launch raises. Both kernels are one mainloop
  (`csrc/gram_tri_sm90.cuh`): TMA
  loads into a shared-memory ring, wgmma on the tensor cores, persistent
  CTAs walking the lower-triangular tiles in the order `tile_order` gives,
  each tile's markers split as `marker_splits` says (`tile_schedule`), in
  clusters of CTAs that share operand boxes by TMA multicast (`tiling`).
- What bounds K2 on bf16 past the operations is the bytes each tile stages
  from L2 into shared memory: 64 flop a byte for one CTA per 128x128 tile,
  279 GB at 8192x262144. In 2x2 clusters each CTA multicasts one 16 KB box
  a k-block to the two CTAs that read it (142 GB there, 128 flop a byte).
  The CTA tile stays 128x128 because the 1024-marker fold keeps a second
  accumulator in registers: at 128x256 the two would need 256 registers a
  thread, more than a consumer can hold. The clusters' waves are coarser,
  so where one CTA per tile takes a single wave of the SMs that schedule
  stays (`bf16_quad`). With tracing on (`utils/logging.py`) each K2 launch
  counts `gbm.grm.k2.clustered` or `gbm.grm.k2.single`.
- A CPU tensor goes to the plain PyTorch version beside it
  (`gram_tri_int8_plain`, `gram_tri_float_plain`). That is the only reason a
  plain version runs: the device of the tensor decides, nothing else.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.logging import count, tracing_on
from . import _build
from ._build import LAUNCHES, reset_launches

__all__ = [
    "BM",
    "GROUP",
    "LAUNCHES",
    "Tiling",
    "bf16_quad",
    "cta_part",
    "gram_tri_float",
    "gram_tri_float_plain",
    "gram_tri_int8",
    "gram_tri_int8_plain",
    "marker_splits",
    "reset_launches",
    "tile_order",
    "tile_schedule",
    "tiling",
    "tma_operand",
]

_INT32_LIMIT = 2**31  # exact int32 accumulation needs p·ploidy² below this
_F32_EXACT = 2**24  # integers up to 2²⁴ are exact in float32
_PLAIN_CHUNK = 65_536  # marker columns per float32 product in the int8 plain version

# The kernels' tiling (csrc/gram_tri_sm90.cuh): a CTA computes BM output rows
# (two consumer warpgroups x 64) by `_CTA_N` columns, a cluster of
# cluster_m x cluster_n CTAs (`tiling`) shares a tile of TILE_M x TILE_N,
# GROUP row blocks of TILE_M make an L2 group of the tile order, markers come
# in k-blocks of _ROW_BYTES bytes per row, and a tile takes at most
# `_MAX_SPLITS` marker splits of at least _MIN_SPLIT_BLOCKS k-blocks.
BM = 128
GROUP = 16
_CTA_N = {torch.int8: 256, torch.bfloat16: 128, torch.float32: 128}
_MAX_SPLITS = {torch.int8: 8, torch.bfloat16: 2, torch.float32: 2}
_ROW_BYTES = 128
_MIN_SPLIT_BLOCKS = 64
_TMA_ALIGN = 16  # bytes: TMA wants the base and the row stride on this multiple


class Tiling(NamedTuple):
    """How the kernel tiles the Gram of one panel: clusters of cluster_m x
    cluster_n CTAs, each cluster owning a tile_m x tile_n tile of the output
    and each CTA a BM x tile_n / cluster_n part of it, with at most
    max_splits marker splits a tile."""

    cluster_m: int
    cluster_n: int
    tile_m: int
    tile_n: int
    max_splits: int

    @property
    def ctas(self) -> int:
        return self.cluster_m * self.cluster_n


def bf16_quad(n: int, sms: int) -> bool:
    """Whether K2 runs a bf16 panel of n entries in 2x2 clusters on a card
    with `sms` SMs, as `bf16_quad` in the kernel's header: where one CTA per
    128x128 lower-triangular tile would take more than one wave of the SMs;
    one CTA per tile where they fit one wave."""
    nr = -(-n // BM)
    return nr * (nr + 1) // 2 > sms


def tiling(dtype: torch.dtype, n: int, sms: int) -> Tiling:
    """The kernel's tiling of an (n, p) panel of `dtype` on a card with `sms`
    SMs: K1 in 2x1 clusters sharing B, K2 on f32 one CTA per tile, K2 on bf16
    in 2x2 clusters sharing A and B where `bf16_quad`, else one CTA per tile."""
    if dtype == torch.int8:
        cm, cn = 2, 1
    elif dtype == torch.bfloat16 and bf16_quad(n, sms):
        cm, cn = 2, 2
    else:
        cm, cn = 1, 1
    return Tiling(cm, cn, BM * cm, _CTA_N[dtype] * cn, _MAX_SPLITS[dtype])


def tile_order(n: int, bm: int, bn: int) -> list[tuple[int, int]]:
    """The (row block, column block) tiles of bm x bn the kernel visits, in its order.

    Mirrors `TileCursor` in `csrc/gram_tri_sm90.cuh`: only tiles that touch
    the lower triangle (row block i needs column blocks up to the one
    holding column bm·i + bm - 1); row blocks in groups of GROUP, column
    block outer, row block inner, so that consecutive tiles (one wave of
    persistent clusters) share the marker slabs of few row blocks in L2.
    """
    nr, nc = -(-n // bm), -(-n // bn)

    def last(i):
        return min((bm * i + bm - 1) // bn, nc - 1)

    order = []
    for g0 in range(0, nr, GROUP):
        rows = range(g0, min(g0 + GROUP, nr))
        for j in range(last(rows[-1]) + 1):
            order += [(i, j) for i in rows if j <= last(i)]
    return order


def marker_splits(tiles: int, ctas: int, nk: int, max_splits: int) -> int:
    """Marker splits per tile, as `marker_splits` in the kernel's header: the
    fewest S <= max_splits minimising the waves ceil(S·tiles / ctas) / S, with
    at least 64 of the nk k-blocks per split; ctas counts the persistent
    clusters."""
    best = 1
    for s in range(2, max_splits + 1):
        if s * _MIN_SPLIT_BLOCKS > nk:
            break
        if -(-s * tiles // ctas) * best < -(-best * tiles // ctas) * s:
            best = s
    return best


def tile_schedule(n: int, p: int, dtype: torch.dtype, sms: int) -> list[list[tuple]]:
    """Work units per persistent cluster, as the kernel walks them for an
    (n, p) panel of `dtype` on a card with `sms` SMs, all of them in clusters.

    A unit is (row block, column block, first k-block, end k-block) with
    blocks of `tiling(dtype, n, sms)`'s tile_m x tile_n: the tiles of `tile_order`,
    each cut into `marker_splits` consecutive ranges of the nk k-blocks; unit u
    goes to cluster u % grid, grid = min(sms // ctas, units). Each CTA of the
    cluster computes its own part of the unit's tile (`cta_part`).
    """
    t = tiling(dtype, n, sms)
    order = tile_order(n, t.tile_m, t.tile_n)
    nk = -(-p * torch.empty(0, dtype=dtype).element_size() // _ROW_BYTES)
    clusters = sms // t.ctas
    S = marker_splits(len(order), clusters, nk, t.max_splits)
    units = [(i, j, s * nk // S, (s + 1) * nk // S) for i, j in order for s in range(S)]
    grid = min(clusters, len(units))
    return [units[c::grid] for c in range(grid)]


def cta_part(t: Tiling, i: int, j: int, rank: int) -> tuple[int, int, int, int]:
    """(first row, first column, rows, columns) of tile (i, j) that cluster
    CTA `rank` computes: CTA (rank // cluster_n, rank % cluster_n) of the
    cluster's grid, as the kernel's epilogue writes it."""
    rows, cols = t.tile_m // t.cluster_m, t.tile_n // t.cluster_n
    return i * t.tile_m + rank // t.cluster_n * rows, j * t.tile_n + rank % t.cluster_n * cols, rows, cols


def tma_operand(X: torch.Tensor) -> torch.Tensor:
    """`X` as the kernels' TMA loads need it: a 16-byte aligned base and a row
    stride that is a multiple of 16 bytes.

    Where p·itemsize is not a multiple of 16, p is padded with zero columns
    (they add nothing to X·Xᵀ); a misaligned base (a sliced view) is copied.
    Otherwise `X` itself is returned, with no copy.
    """
    n, p = X.shape
    q = _TMA_ALIGN // X.element_size()
    pp = -(-p // q) * q
    if pp != p:
        Y = X.new_zeros((n, pp))
        Y[:, :p] = X
        return Y
    if X.data_ptr() % _TMA_ALIGN:
        return X.clone()
    return X


def _check_panel(X, name: str, dtypes) -> None:
    if not isinstance(X, torch.Tensor):
        raise TypeError(f"{name} wants a torch.Tensor, got {type(X).__name__}")
    if X.dtype not in dtypes:
        raise TypeError(f"{name} wants dtype in {[str(d) for d in dtypes]}, got {X.dtype}")
    if X.dim() != 2:
        raise ValueError(f"{name} wants a 2-D (n, p) panel, got shape {tuple(X.shape)}")
    if not X.is_contiguous():
        raise ValueError(f"{name} wants a contiguous (row-major) panel")
    if X.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda tensors, got {X.device}")


def _launch(entry: str, X: torch.Tensor, out: torch.Tensor) -> None:
    X = tma_operand(X)
    n, p = X.shape
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        _build.launch(entry, X.data_ptr(), out.data_ptr(), n, p, stream)


def gram_tri_int8_plain(D: torch.Tensor, ploidy: int = 2) -> torch.Tensor:
    """tril(D·Dᵀ) in int32, exact.

    Float32 products over column chunks of width w with w·ploidy² < 2²⁴: every
    partial sum is then an integer below 2²⁴, hence exact in float32 (with
    TF32 off on the card), and the chunks add up exactly in int32.
    """
    n, p = D.shape
    w = max(1, min(_PLAIN_CHUNK, (_F32_EXACT - 1) // max(ploidy * ploidy, 1)))
    acc = torch.zeros((n, n), dtype=torch.int32, device=D.device)
    for s in range(0, p, w):
        blk = D[:, s : s + w].to(torch.float32)
        acc += (blk @ blk.T).to(torch.int32)
    return torch.tril(acc)


def gram_tri_int8(D: torch.Tensor, ploidy: int = 2) -> torch.Tensor:
    """K1: lower-triangular raw Gram of an int8 dosage panel, int32, exact.

    `D` holds dosages in {0, ..., ploidy}. Exact while p·ploidy² < 2³¹;
    raises beyond that instead of overflowing. On the card, a panel whose p
    is not a multiple of 16 is padded with zero columns, and one whose base
    is not 16-byte aligned is copied, before the kernel reads it (`tma_operand`).
    """
    _check_panel(D, "gram_tri_int8", (torch.int8,))
    n, p = D.shape
    if ploidy < 1:
        raise ValueError(f"ploidy must be >= 1, got {ploidy}")
    if p * ploidy * ploidy >= _INT32_LIMIT:
        raise ValueError(
            f"int32 Gram overflows: p·ploidy² = {p}·{ploidy}² >= 2³¹; split the "
            "markers into blocks and add the raw Grams"
        )
    if D.device.type == "cpu":
        return gram_tri_int8_plain(D, ploidy)
    out = torch.zeros((n, n), dtype=torch.int32, device=D.device)
    if n and p:
        _launch("gbm_gram_tri_int8", D, out)
        _build.count_launch("gram_tri_int8", ("int8", n, p))
    return out


def gram_tri_float_plain(X: torch.Tensor) -> torch.Tensor:
    """tril(X·Xᵀ) rounded to float32 from a float64 product.

    float64 keeps the reference's own rounding far below the kernel's: a
    float32 product over tens of thousands of markers rounds by the order of
    the 1e-5·max|G| tolerance the kernel is held to.
    """
    Xd = X.to(torch.float64)
    return torch.tril(Xd @ Xd.T).to(torch.float32)


def gram_tri_float(X: torch.Tensor) -> torch.Tensor:
    """K2: lower-triangular raw Gram of an f32 or bf16 panel, f32 accumulation.

    On the card, f32 runs as 3xTF32 on the tensor cores and bf16 as bf16
    wgmma (in 2x2 clusters where `bf16_quad`), both within 1e-5·max|G| of
    the float64 plain version. A panel
    whose row is not a multiple of 16 bytes (p % 4 for f32, p % 8 for bf16)
    is padded with zero columns, and one whose base is not 16-byte aligned is
    copied, before the kernel reads it (`tma_operand`).
    """
    _check_panel(X, "gram_tri_float", (torch.float32, torch.bfloat16))
    if X.device.type == "cpu":
        return gram_tri_float_plain(X)
    n, p = X.shape
    out = torch.zeros((n, n), dtype=torch.float32, device=X.device)
    if n and p:
        entry = "gbm_gram_tri_f32" if X.dtype == torch.float32 else "gbm_gram_tri_bf16"
        _launch(entry, X, out)
        _build.count_launch("gram_tri_float", (str(X.dtype)[6:], n, p))
        if tracing_on():
            sms = torch.cuda.get_device_properties(X.device).multi_processor_count
            count("gbm.grm.k2.clustered" if tiling(X.dtype, n, sms).ctas > 1 else "gbm.grm.k2.single")
    return out
