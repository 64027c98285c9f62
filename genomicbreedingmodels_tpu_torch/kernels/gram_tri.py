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
  each tile's markers split as `marker_splits` says (`tile_schedule`).
- A CPU tensor goes to the plain PyTorch version beside it
  (`gram_tri_int8_plain`, `gram_tri_float_plain`). That is the only reason a
  plain version runs: the device of the tensor decides, nothing else.
"""

from __future__ import annotations

import torch

from . import _build
from ._build import LAUNCHES, reset_launches

__all__ = [
    "BM",
    "CLUSTER",
    "GROUP",
    "LAUNCHES",
    "MAX_SPLITS",
    "TILE_M",
    "TILE_N",
    "gram_tri_float",
    "gram_tri_float_plain",
    "gram_tri_int8",
    "gram_tri_int8_plain",
    "marker_splits",
    "reset_launches",
    "tile_order",
    "tile_schedule",
    "tma_operand",
]

_INT32_LIMIT = 2**31  # exact int32 accumulation needs p·ploidy² below this
_F32_EXACT = 2**24  # integers up to 2²⁴ are exact in float32
_PLAIN_CHUNK = 65_536  # marker columns per float32 product in the int8 plain version

# The kernels' tiling (csrc/gram_tri_sm90.cuh) by operand type: CLUSTER CTAs
# of BM output rows each (two consumer warpgroups x 64) share a tile of
# TILE_M = CLUSTER·BM rows by TILE_N columns, GROUP row blocks of TILE_M make
# an L2 group of the tile order, markers come in k-blocks of _ROW_BYTES bytes
# per row, and a tile takes at most MAX_SPLITS marker splits of at least
# _MIN_SPLIT_BLOCKS k-blocks.
BM = 128
GROUP = 16
CLUSTER = {torch.int8: 2, torch.bfloat16: 1, torch.float32: 1}
TILE_M = {dt: BM * c for dt, c in CLUSTER.items()}
TILE_N = {torch.int8: 256, torch.bfloat16: 128, torch.float32: 128}
MAX_SPLITS = {torch.int8: 8, torch.bfloat16: 2, torch.float32: 2}
_ROW_BYTES = 128
_MIN_SPLIT_BLOCKS = 64
_TMA_ALIGN = 16  # bytes: TMA wants the base and the row stride on this multiple


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
    blocks of TILE_M x TILE_N: the tiles of `tile_order`, each cut into
    `marker_splits` consecutive ranges of the nk k-blocks; unit u goes to
    cluster u % grid, grid = min(sms // CLUSTER, units).
    """
    order = tile_order(n, TILE_M[dtype], TILE_N[dtype])
    nk = -(-p * torch.empty(0, dtype=dtype).element_size() // _ROW_BYTES)
    clusters = sms // CLUSTER[dtype]
    S = marker_splits(len(order), clusters, nk, MAX_SPLITS[dtype])
    units = [(i, j, s * nk // S, (s + 1) * nk // S) for i, j in order for s in range(S)]
    grid = min(clusters, len(units))
    return [units[c::grid] for c in range(grid)]


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
    wgmma, both within 1e-5·max|G| of the float64 plain version. A panel
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
    return out
