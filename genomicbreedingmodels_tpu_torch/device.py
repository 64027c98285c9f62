"""Explicit device placement for the port's entry points.

Every public entry point takes `device=` (default "cuda") and hands it to
these helpers. Nothing here chooses a device on the caller's behalf: asking
for CUDA where PyTorch has none raises instead of quietly running on the host.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["as_tensor", "resolve_device"]


def resolve_device(device) -> torch.device:
    """`torch.device(device)`, raising if it names CUDA and none is usable."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was requested but this PyTorch build sees no "
            "CUDA device; pass device='cpu' to run the plain versions on the host"
        )
    return dev


def as_tensor(x, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """`x` (numpy array, tensor or scalar) as a tensor on `device`."""
    dev = resolve_device(device)
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)
