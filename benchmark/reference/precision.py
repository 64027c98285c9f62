"""The lower precisions the controls compute in."""

from __future__ import annotations

from contextlib import contextmanager

import torch

FP8_MAX = 448.0  # the largest float8 e4m3 number


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded to float8 e4m3 under one scale for the whole tensor (its
    largest magnitude maps to the format's largest number), as an fp8
    product reads its operands; returned in `t`'s dtype."""
    amax = t.abs().max().clamp(min=1e-30)
    return ((t * (FP8_MAX / amax)).to(torch.float8_e4m3fn).to(t.dtype)) * (amax / FP8_MAX)


@contextmanager
def tf32(on: bool = True):
    """float32 products in TF32 (on) or in full float32 (off) inside the block."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
