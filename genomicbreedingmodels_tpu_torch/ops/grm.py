"""Gram-matrix ops (GRM hot path) on torch tensors.

Port of genomicbreedingmodels_tpu/ops/grm.py. The raw Gram X·Xᵀ, the single
O(n²p) item of the GBLUP stack, comes from the triangular kernels in
`kernels/gram_tri.py`: K1 (exact int8 dosages) or K2 (f32/bf16 panels) on a
CUDA tensor, their plain versions on a CPU tensor. Only the lower triangle is
computed; the symmetric matrix, where a caller needs one, is mirrored here.

Centering is never done by materialising X - 1μᵀ. Column-centering X is the
projection P = I - 11ᵀ/n on the left, so the centered Gram is K = P (X Xᵀ) P:
double-centering of the raw Gram, an O(n²) epilogue, with float64 row means
and the correction ordered so that float32 leaves no bias along the ones
vector (`centering_terms`).

SNP-major shards (the .bed order, (markers, n)) reach K1 through
`gram_tri_snp_major`: one transposing copy into a buffer K1 reads as it is
(`entry_major`), for the out-of-core GRM (streaming.py) and the pieces path.

Dosage panels: allele frequencies on the grid {0, 1/k, ..., 1} encode
exactly as int8 dosages d = k·x (`encode_dosage`), and their raw Gram
accumulates exactly in int32 (K1). `gram_auto` picks the path.

The JAX package's other schedules are here as library products
(`torch.matmul`, float32 output; a bf16 panel is cast to float32 first, which
gives the JAX products' `preferred_element_type=f32` results exactly on the
CPU and, with TF32 off, on the card): `gram_recursive` (the 2x2 recursion),
`gram_triangular` (square row-block tiles of the lower triangle) and
`gram_centered_blocked` (= `gram_centered`); `gram_centered_device` is
`gram_panel` (K2) in both its modes, as the JAX default is its
`gram_panel`. The headline and every model take K1 or K2.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import as_tensor
from ..kernels.gram_tri import gram_tri_float, gram_tri_int8

__all__ = [
    "center_gram",
    "center_gram_lower",
    "centering_terms",
    "encode_dosage",
    "entry_major",
    "gram_auto",
    "gram_centered",
    "gram_centered_blocked",
    "gram_centered_device",
    "gram_dosage",
    "gram_dosage_lower",
    "gram_dosage_snp_major",
    "gram_panel",
    "gram_recursive",
    "gram_tri_snp_major",
    "gram_triangular",
]


def _mirror(L: torch.Tensor) -> torch.Tensor:
    """Symmetric matrix from a lower triangle whose strict upper part is zero."""
    return L + torch.tril(L, -1).T


def centering_terms(rm: torch.Tensor, dtype: torch.dtype):
    """(a, b, c) in `dtype` from the float64 row means `rm` of a raw Gram, such
    that the centered entry G_ij - (rm_i + rm_j - gm) is ((G_ij - a_i) - b_j) - c_i.

    a = rm rounded, c = rm - a (what a misses), b = rm - gm, each rounded once.
    A float32 rm_i ~ 1e5 carries a rounding of ~4e-3, the same along its whole
    row, and a float32 gm a rounding of ~1e-2 on every entry: at n = 50,000,
    subtracting rm_i + rm_j - gm formed in float32 left the null direction
    (the ones vector) of the centered Gram at -192 instead of 0, below
    λ = 1e-3·mean(diag K) = 83, so CG and Cholesky of K + λI diverged.
    G_ij - a_i is exact where the two are within a factor 2 (raw Gram entries
    beside their row mean), and b and c, small, round on their own scale, so
    no such bias is left.
    """
    gm = rm.mean()
    a = rm.to(dtype)
    return a, (rm - gm).to(dtype), (rm - a.to(rm.dtype)).to(dtype)


def _center(X: torch.Tensor, rm: torch.Tensor) -> torch.Tensor:
    """X - (rm_i + rm_j - gm) as `centering_terms` orders it, in a new tensor."""
    a, b, c = centering_terms(rm, X.dtype)
    H = X - a[:, None]
    H -= b[None, :]
    H -= c[:, None]
    return H


def center_gram(G: torch.Tensor) -> torch.Tensor:
    """Double-center a raw Gram G = X Xᵀ into P G P, P = I - 11ᵀ/n.

    Row means in float64, the correction as `_center` applies it; the result
    is made exactly symmetric by mirroring its lower triangle.
    """
    H = _center(G, G.sum(dim=1, dtype=torch.float64) / G.shape[0])
    return torch.tril(H) + torch.tril(H, -1).T


def _row_means_lower(L: torch.Tensor) -> torch.Tensor:
    """Float64 row means of the symmetric Gram whose lower triangle is L
    (strict upper zero): rowsum + colsum - diag."""
    return (L.sum(dim=1, dtype=torch.float64) + L.sum(dim=0, dtype=torch.float64)
            - L.diagonal().to(torch.float64)) / L.shape[0]


def _center_gram_lower(L: torch.Tensor) -> torch.Tensor:
    """`center_gram_lower` without the precondition check (no host sync), for
    producers that guarantee a zero strict upper triangle (K1, K2)."""
    return _center(L, _row_means_lower(L))


def center_gram_lower(L: torch.Tensor) -> torch.Tensor:
    """Double-center a LOWER-TRIANGLE-ONLY raw Gram (strict upper triangle zero).

    The full row means are recovered from the triangle as rowsum + colsum -
    diag. Only the lower triangle of the result is meaningful (the upper holds
    -(rm_i + rm_j - gm)); feed it to consumers that read one triangle
    (ops/chol.py:gblup_solve_lower).

    PRECONDITION, checked here (one host sync): the strict upper triangle of
    `L` is zero. A full symmetric Gram would double-count the off-diagonal
    mass in the recovered row means.
    """
    if L.numel():
        bad = float(torch.triu(L, diagonal=1).abs().max())
        if bad != 0.0:
            raise ValueError(
                "center_gram_lower got a matrix with nonzero strict upper "
                f"triangle (max |upper| = {bad:.3e}); pass the lower "
                "triangle only, or use center_gram for symmetric input"
            )
    return _center_gram_lower(L)


def gram_panel(X, center: bool = True, device="cuda") -> torch.Tensor:
    """Centered (or raw) Gram of a continuous panel via K2, f32 (n, n).

    `X` (numpy or tensor) is taken as f32 unless it is already bf16.
    """
    bf16 = isinstance(X, torch.Tensor) and X.dtype == torch.bfloat16
    X = as_tensor(X, device, torch.bfloat16 if bf16 else torch.float32)
    G = _mirror(gram_tri_float(X.contiguous()))
    return center_gram(G) if center else G


def gram_centered(X, block_cols: int = 262_144, device="cuda") -> torch.Tensor:
    """(X - colmean)(X - colmean)ᵀ, streamed over column blocks.

    At most n x `block_cols` panel values are on the device at once; the raw
    Gram is additive over column blocks and is double-centered once at the end
    (the centering projection is not additive, so it must not run per block).
    """
    n, p = X.shape
    if p <= block_cols:
        return gram_panel(X, device=device)
    out = None
    for start in range(0, p, block_cols):
        G = gram_panel(X[:, start : start + block_cols], center=False, device=device)
        out = G if out is None else out.add_(G)
    return center_gram(out)


def encode_dosage(X, ploidy: int = 2, tol: float = 1e-6):
    """Encode an allele-frequency panel on the grid {0, 1/k, ..., 1} as int8
    dosages d = k·x (numpy). Returns None when any value is off-grid (> `tol`
    from the nearest multiple of 1/ploidy): the panel then takes the K2 path.
    """
    if ploidy < 1 or ploidy > 127:
        return None
    X = np.asarray(X)
    D = X * float(ploidy)
    Dr = np.rint(D)
    if not bool(np.all(np.abs(D - Dr) <= tol * ploidy)):
        return None
    if Dr.min() < 0 or Dr.max() > ploidy:
        return None
    return Dr.astype(np.int8)


def _dosage_tensor(D, device, name: str) -> torch.Tensor:
    D = as_tensor(D, device)
    if D.dtype != torch.int8:
        raise TypeError(f"{name} wants int8 dosages, got {D.dtype}")
    return D.contiguous()


def gram_dosage(D, ploidy: int = 2, center: bool = True, device="cuda") -> torch.Tensor:
    """Centered (or raw) Gram of an int8 dosage panel via K1.

    The raw Gram accumulates exactly in int32, then scales by 1/ploidy² and
    double-centers in f32. Exact while p·ploidy² < 2³¹.
    """
    D = _dosage_tensor(D, device, "gram_dosage")
    G = _mirror(gram_tri_int8(D, ploidy)).to(torch.float32) / float(ploidy * ploidy)
    return center_gram(G) if center else G


def gram_dosage_lower(D, ploidy: int = 2, device="cuda") -> torch.Tensor:
    """Centered Gram of an int8 dosage panel, LOWER TRIANGLE ONLY.

    The symmetric matrix is never built; the result is for consumers that read
    one triangle (`ops/chol.py:gblup_solve_lower`). No host sync: K1 leaves
    the strict upper triangle zero, so the precondition needs no check.
    """
    D = _dosage_tensor(D, device, "gram_dosage_lower")
    L = gram_tri_int8(D, ploidy).to(torch.float32) / float(ploidy * ploidy)
    return _center_gram_lower(L)


def gram_auto(X, ploidy: int = 2, center: bool = True, device="cuda") -> torch.Tensor:
    """Centered Gram with automatic path selection: exact int8 dosages (K1)
    when the panel sits on the {0, 1/ploidy, ..., 1} grid or is an int8
    tensor of dosages already, K2 otherwise."""
    if isinstance(X, np.ndarray):
        D = encode_dosage(X, ploidy=ploidy)
        if D is not None:
            return gram_dosage(D, ploidy=ploidy, center=center, device=device)
    elif isinstance(X, torch.Tensor) and X.dtype == torch.int8:
        return gram_dosage(X, ploidy=ploidy, center=center, device=device)
    return gram_panel(X, center=center, device=device)


def entry_major(F: torch.Tensor, rows: int | None = None) -> torch.Tensor:
    """An SNP-major (cols, n) int8 shard as an entry-major (rows, cols') panel
    in ONE copy: the transpose writes straight into a buffer whose row is
    already a multiple of 16 bytes (K1's TMA wants it, `torch._int_mm` a
    multiple of 8; zero columns add nothing to a Gram) and which has `rows`
    >= n rows, the rows past n zero. K1 then reads the buffer as it is
    (`tma_operand` copies nothing), where a plain `F.T.contiguous()` of an
    unaligned shard would be copied a second time."""
    cols, n = F.shape
    rows = n if rows is None else rows
    cp = -(-cols // 16) * 16
    D = torch.empty((rows, cp), dtype=F.dtype, device=F.device)
    D[:n, :cols].copy_(F.T)
    D[n:].zero_()
    D[:n, cols:].zero_()
    return D


def gram_tri_snp_major(F, ploidy: int = 2, device="cuda") -> torch.Tensor:
    """Raw lower-triangular int32 Gram D·Dᵀ (strict upper triangle zero) of an
    SNP-major (cols, n) int8 dosage shard, D = Fᵀ, via K1 on the card. The
    unscaled, uncentered form that `streaming.grm_from_bed` adds up over
    shards, exactly, before it scales and centers once."""
    F = _dosage_tensor(F, device, "gram_dosage_snp_major")
    D = entry_major(F)
    return gram_tri_int8(D, ploidy)


def gram_dosage_snp_major(F, ploidy: int = 2, center: bool = True, device="cuda") -> torch.Tensor:
    """`gram_dosage` for an SNP-major (cols, n) int8 dosage shard (the .bed
    native order, as `BedShardStreamer.iter_dosage(snp_major=True)` yields it).

    The shard is transposed on the device into a K1-ready buffer (one copy,
    `entry_major`), its raw Gram accumulates exactly in int32 (K1), then
    scales by 1/ploidy² and double-centers (or not) in f32. The same Gram as
    `gram_dosage(F.T)`.
    """
    L = gram_tri_snp_major(F, ploidy, device)
    G = _mirror(L).to(torch.float32) / float(ploidy * ploidy)
    return center_gram(G) if center else G


def _full_gram(Z: torch.Tensor, center: bool) -> torch.Tensor:
    G = Z @ Z.T
    return center_gram(G) if center else G


def gram_centered_blocked(X, block_cols: int = 262_144, device="cuda") -> torch.Tensor:
    """`gram_centered` under the JAX package's other name."""
    return gram_centered(X, block_cols=block_cols, device=device)


def _assemble_recursive(Z: torch.Tensor, d: int) -> torch.Tensor:
    """Symmetric Z Zᵀ by 2x2 recursion: the off-diagonal block of each level
    is one product, the diagonal blocks recurse `d` levels deep."""
    if d == 0:
        return Z @ Z.T
    m = Z.shape[0] // 2
    A, B = Z[:m], Z[m:]
    off = B @ A.T
    G = torch.empty((Z.shape[0], Z.shape[0]), dtype=Z.dtype, device=Z.device)
    G[:m, :m] = _assemble_recursive(A, d - 1)
    G[m:, m:] = _assemble_recursive(B, d - 1)
    G[m:, :m] = off
    G[:m, m:] = off.T
    return G


def gram_recursive(X, center: bool = True, depth: int | None = None, device="cuda") -> torch.Tensor:
    """Centered (or raw) Gram, f32 (n, n), by recursive symmetric blocking.

    The default depth keeps leaf diagonal blocks of at least 512 rows (at
    most 4 levels), as the JAX twin's."""
    Z = as_tensor(X, device, torch.float32)
    n = Z.shape[0]
    if depth is None:
        depth = 0
        while n >> (depth + 1) >= 512 and depth < 4:
            depth += 1
    if depth == 0:
        return _full_gram(Z, center)
    G = _assemble_recursive(Z, int(depth))
    return center_gram(G) if center else G


def gram_triangular(X, center: bool = True, nb: int | None = None, device="cuda") -> torch.Tensor:
    """Centered (or raw) Gram, f32 (n, n), from nb x nb square row-block
    tiles of the lower triangle, the panel zero-padded to nb·ceil(n/nb) rows,
    each upper tile the transpose of its lower twin.

    As the JAX twin: nb defaults to max(2, min(8, n // 1024)), and n < 2048
    or nb < 2 takes one product."""
    Z = as_tensor(X, device, torch.float32)
    n = Z.shape[0]
    if nb is None:
        nb = max(2, min(8, n // 1024))
    if n < 2048 or nb < 2:
        return _full_gram(Z, center)
    b = -(-n // nb)
    if nb * b > n:
        Z = torch.cat([Z, Z.new_zeros((nb * b - n, Z.shape[1]))])
    G = torch.empty((nb * b, nb * b), dtype=Z.dtype, device=Z.device)
    for i in range(nb):
        Zi = Z[i * b : (i + 1) * b]
        for j in range(i + 1):
            T = Zi @ Z[j * b : (j + 1) * b].T
            G[i * b : (i + 1) * b, j * b : (j + 1) * b] = T
            if j < i:
                G[j * b : (j + 1) * b, i * b : (i + 1) * b] = T.T
    G = G[:n, :n]
    return center_gram(G) if center else G.contiguous()


def gram_centered_device(X, use_pallas: bool = False, device="cuda") -> torch.Tensor:
    """Device-resident centered Gram, f32 (n, n): `gram_panel` (K2, a bf16
    panel kept bf16) either way. The JAX default is its `gram_panel` and its
    `use_pallas=True` option the Pallas kernel that K2 ports, so both modes
    are the same call here."""
    return gram_panel(X, device=device)
