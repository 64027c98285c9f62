"""Triangular raw Gram kernels K1 (int8 dosages) and K2 (f32/bf16 panels).

Port of genomicbreedingmodels_tpu/ops/pallas_kernels.py: `gram_tri_kernel_int8`
(K1) and `gram_tri_kernel` (K2). Both compute only the lower-triangular output
tiles of the raw Gram X·Xᵀ of an (n, p) entry-major panel; centering and
scaling stay outside, in ops/grm.py.

Contract of both wrappers: the result is (n, n) with the lower triangle
(diagonal included) holding X·Xᵀ and the strict upper triangle exactly zero.

- A CUDA tensor goes to the hand-written kernel in `csrc/` (built by nvcc at
  first use, see `_build.py`), launched on the current stream, and the
  kernel's entry in `LAUNCHES` goes up by one. A failed build or launch raises.
- A CPU tensor goes to the plain PyTorch version beside it
  (`gram_tri_int8_plain`, `gram_tri_float_plain`). That is the only reason a
  plain version runs: the device of the tensor decides, nothing else.
"""

from __future__ import annotations

import torch

from . import _build
from ._build import LAUNCHES, reset_launches

__all__ = [
    "LAUNCHES",
    "gram_tri_float",
    "gram_tri_float_plain",
    "gram_tri_int8",
    "gram_tri_int8_plain",
    "reset_launches",
]

_INT32_LIMIT = 2**31  # exact int32 accumulation needs p·ploidy² below this
_F32_EXACT = 2**24  # integers up to 2²⁴ are exact in float32
_PLAIN_CHUNK = 65_536  # marker columns per float32 product in the int8 plain version


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
    raises beyond that instead of overflowing.
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
        LAUNCHES["gram_tri_int8"] += 1
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
    """K2: lower-triangular raw Gram of an f32 or bf16 panel, f32 accumulation."""
    _check_panel(X, "gram_tri_float", (torch.float32, torch.bfloat16))
    if X.device.type == "cpu":
        return gram_tri_float_plain(X)
    n, p = X.shape
    out = torch.zeros((n, n), dtype=torch.float32, device=X.device)
    if n and p:
        entry = "gbm_gram_tri_f32" if X.dtype == torch.float32 else "gbm_gram_tri_bf16"
        _launch(entry, X, out)
        LAUNCHES["gram_tri_float"] += 1
    return out
