"""Trapezoid-piece Gram: lower-triangle-only streamed GRM + CG GBLUP for
panels whose square Gram need not exist on the device.

Port of genomicbreedingmodels_tpu/ops/pieces.py. The Gram is stored as nb
BLOCK-COLUMN TRAPEZOID PIECES (piece j = rows lo_j.., cols lo_j..hi_j of the
lower triangle), so:

- each marker shard's update is one int8 product per piece with EXACT int32
  accumulation (panel products < 2³¹ for p·ploidy² < 2³¹), added in place
  into the piece (the JAX package donates the piece buffers to the same
  effect). On the card the product is `torch._int_mm` (cuBLAS): the piece
  product is a plain int8 GEMM outside any Pallas kernel in the reference,
  and K1 computes only square lower triangles. On the CPU it is a float64
  product, exact for any panel of this package's sizes;
- double-centering recovers full row means from the triangle as
  rowsum + colsum − diag (ops/grm.py:center_gram_lower, piecewise);
- the mixed-model solve is matrix-free CG whose matvec applies each piece
  and its mirror (K = L + Lᵀ − diag L): no second n × n buffer ever.

The functions take and return tensors and run where the pieces lie; only
`zero_pieces` takes `device=`. Nothing here syncs with the host.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..device import resolve_device
from .grm import centering_terms, entry_major

__all__ = [
    "make_bounds",
    "zero_pieces",
    "accumulate_dosage_shard",
    "accumulate_bed_payload",
    "unpack_bed_payload",
    "center_scale_pieces",
    "cg_solve_pieces",
    "gblup_from_pieces",
]

Bounds = Tuple[Tuple[int, int], ...]

# torch._int_mm on the card wants more than 16 rows in its first operand and
# a multiple of 8 in the inner and the output column dimension: the panel
# gets this many zero rows past n, so the last (ragged or short) piece can be
# computed on a padded operand and sliced.
_PAD_ROWS = 24
# The 2-bit .bed codes 0b00, 0b01 (missing), 0b10, 0b11 map to dosages
# 0, 0, 1, 2: a four-entry lookup table of 2-bit fields in one byte, read as
# (_LUT >> 2·code) & 3.
_LUT = 0b10_01_00_00
_MISSING = 1


def make_bounds(n: int, b: int = 4096) -> Bounds:
    """Row-block boundaries for n rows in width-b panels (last one ragged)."""
    bounds = []
    lo = 0
    while lo < n:
        bounds.append((lo, min(lo + b, n)))
        lo = min(lo + b, n)
    return tuple(bounds)


def zero_pieces(n: int, bounds: Bounds, dtype=torch.int32, device="cuda") -> List[torch.Tensor]:
    """Freshly zeroed trapezoid pieces (int32 for the exact dosage path)."""
    dev = resolve_device(device)
    return [torch.zeros((n - lo, hi - lo), dtype=dtype, device=dev) for lo, hi in bounds]


def accumulate_dosage_shard(
    pieces: List[torch.Tensor], F: torch.Tensor, *, bounds: Bounds, snp_major: bool = True
) -> List[torch.Tensor]:
    """pieces += lower-trapezoid syrk of one int8 dosage shard, in place:
    pieces[j] += D[lo_j:n] · D[lo_j:hi_j]ᵀ in int32, exact for
    p_total · ploidy² < 2³¹, with D the entry-major shard.

    F: (cols, n) int8 snp-major (the .bed native order; pass snp_major=False
    for an (n, cols) shard), on the pieces' device. D is F transposed into a
    buffer with _PAD_ROWS zero rows past n and a row padded to 16 bytes
    (`entry_major`), so that on the card the short or ragged last piece runs
    on padded operands and is sliced. Returns `pieces`.
    """
    n = pieces[0].shape[0]
    D = entry_major(F if snp_major else F.T, rows=n + _PAD_ROWS)
    for (lo, hi), piece in zip(bounds, pieces):
        m, w = n - lo, hi - lo
        if D.is_cuda:
            A = D[lo : lo + max(m, 17)]
            B = D[lo : lo + -(-w // 8) * 8]
            panel = torch._int_mm(A, B.T)[:m, :w]
        else:
            panel = (D[lo:n].double() @ D[lo:hi].double().T).to(torch.int32)
        piece.add_(panel)
    return pieces


def _check_payload(payload, n: int) -> None:
    if not isinstance(payload, torch.Tensor) or payload.dtype != torch.uint8 or payload.dim() != 2:
        raise TypeError("unpack_bed_payload wants a 2-D (cols, ceil(n/4)) uint8 tensor")
    if payload.shape[1] != (n + 3) // 4:
        raise ValueError(f"payload rows hold {payload.shape[1]} bytes; n={n} needs {(n + 3) // 4}")


def unpack_bed_payload(payload: torch.Tensor, n: int):
    """Device-side PLINK 2-bit unpack: (cols, ceil(n/4)) uint8 → ((cols, n)
    int8 dosages with missing mapped to 0, missing-call count as a 0-d int64
    tensor).

    One payload byte carries FOUR genotypes, so shipping it packed moves a
    quarter of the bytes of int8 dosages over the host→device link. The
    unpack is uint8 shifts and masks and a four-entry lookup table.

    .bed code → dosage: 0b00→0 (hom A1), 0b10→1 (het), 0b11→2 (hom A2);
    0b01 (missing) maps to dosage 0 and is COUNTED — callers that need exact
    Grams must check the returned count. The padding bit pairs of the last
    byte (n % 4 ≠ 0) lie past n and are sliced off before the count.
    """
    _check_payload(payload, n)
    codes = torch.stack([(payload >> s) & 3 for s in (0, 2, 4, 6)], dim=-1)
    codes = codes.reshape(payload.shape[0], -1)[:, :n]
    n_missing = (codes == _MISSING).sum()
    lut = torch.tensor(_LUT, dtype=torch.uint8, device=payload.device)
    return ((lut >> (codes << 1)) & 3).view(torch.int8), n_missing


def accumulate_bed_payload(
    pieces: List[torch.Tensor], payload: torch.Tensor, miss: torch.Tensor, *, bounds: Bounds, n: int
):
    """pieces += trapezoid syrk of one PACKED .bed shard, unpacked on the
    device (`unpack_bed_payload`, then `accumulate_dosage_shard`): the packed
    bytes are the only host→device transfer and the int8 dosage shard exists
    only on the device. `miss` is a running missing-call counter (a 0-d
    tensor, read by the caller). Returns (pieces, miss + this shard's count);
    the pieces are updated in place."""
    D, n_missing = unpack_bed_payload(payload, n)
    return accumulate_dosage_shard(pieces, D, bounds=bounds), miss + n_missing


def center_scale_pieces(
    pieces: List[torch.Tensor], ploidy_sq: float, *, bounds: Bounds
) -> List[torch.Tensor]:
    """Scale raw int32 pieces by 1/ploidy² and double-center, in f32.

    CONSUMES `pieces`: each entry of the list is replaced by its f32 piece as
    soon as it is converted, so an int32 piece is freed (where the caller
    holds no other reference) before the next one is converted: the peak is
    the pieces once in f32 plus one int32 piece. The diagonal block of each
    piece is masked to its lower half first (the panel product computed the
    full block), and the centering correction is applied to the lower
    trapezoid only, so the strict upper half STAYS exactly zero (the CG
    matvec multiplies the full piece buffer). Row sums in float64 and the
    correction as ops/grm.py:centering_terms orders it: formed in float32,
    it biased the null direction of K below λ at n = 50,000. Returns the
    same list.
    """
    n = pieces[0].shape[0]
    dev = pieces[0].device
    rs = torch.zeros(n, dtype=torch.float64, device=dev)
    cs = torch.zeros(n, dtype=torch.float64, device=dev)
    dg = torch.zeros(n, dtype=torch.float64, device=dev)
    for j, (lo, hi) in enumerate(bounds):
        w = hi - lo
        P = pieces[j].to(torch.float32).div_(ploidy_sq)
        pieces[j] = P
        P[:w] = torch.tril(P[:w])
        rs[lo:] += P.sum(dim=1, dtype=torch.float64)
        cs[lo:hi] += P.sum(dim=0, dtype=torch.float64)
        dg[lo:hi] = P[:w].diagonal()
    a, b, c = centering_terms((rs + cs - dg) / n, torch.float32)
    for (lo, hi), P in zip(bounds, pieces):
        w = hi - lo
        P -= a[lo:, None]
        P -= b[None, lo:hi]
        P -= c[lo:, None]
        P[:w] = torch.tril(P[:w])
    return pieces


def cg_solve_pieces(
    pieces: List[torch.Tensor],
    y: torch.Tensor,
    lam_rel,
    *,
    bounds: Bounds,
    iters: int = 30,
):
    """GBLUP by CG straight from centered lower-trapezoid pieces.

    Solves (K + λI) α = y_c with K = L + Lᵀ − diag L applied piecewise (each
    piece contributes its block-column of L and, transposed, its block-row of
    Lᵀ; the double-counted diagonal is removed) and λ = lam_rel · mean(diag K).
    A Python loop of `iters` steps with no host sync: the breakdown guards
    are `clamp_min`, so once converged (rs → 0) a step is a no-op instead of
    0/0. Returns (gebv, resid_norm) as tensors: the GEBV uses K α = y_c − λ α,
    so the final n × n matvec is algebraically free.
    """
    mu = y.mean()
    yc = y - mu
    n = y.shape[0]
    dg = torch.cat([P[: hi - lo].diagonal() for (lo, hi), P in zip(bounds, pieces)])
    lam = lam_rel * dg.sum() / n

    def mv(v):
        out = lam * v - dg * v
        for (lo, hi), P in zip(bounds, pieces):
            out[lo:] += P @ v[lo:hi]
            out[lo:hi] += P.T @ v[lo:]
        return out

    x = torch.zeros_like(yc)
    r, pvec = yc.clone(), yc.clone()
    rs = r @ r
    for _ in range(iters):
        Ap = mv(pvec)
        alpha = rs / (pvec @ Ap).clamp_min(1e-30)
        x = x + alpha * pvec
        r = r - alpha * Ap
        rs_new = r @ r
        pvec = r + (rs_new / rs.clamp_min(1e-30)) * pvec
        rs = rs_new
    return yc - lam * x + mu, torch.sqrt(r @ r)


def gblup_from_pieces(pieces, y, bounds: Bounds, ploidy: int = 2,
                      lam_rel: float = 1e-3, iters: int = 30):
    """Center raw int32 pieces, then CG-solve. Consumes `pieces` (see
    `center_scale_pieces`). `y` (numpy or tensor) goes to the pieces' device
    in f32. Returns (gebv, resid_norm) as tensors."""
    pieces = center_scale_pieces(pieces, float(ploidy * ploidy), bounds=bounds)
    y = torch.as_tensor(y, dtype=torch.float32).to(pieces[0].device)
    return cg_solve_pieces(pieces, y, float(lam_rel), bounds=bounds, iters=iters)
