"""Forward step of the flagship model, torch twin of `__graft_entry__.entry()`."""

from __future__ import annotations

import numpy as np
import torch

from .device import as_tensor
from .ops.grm import gram_panel


def gblup_forward(X: torch.Tensor, y: torch.Tensor, lam) -> torch.Tensor:
    """GEBVs for all entries: the centered Gram K = Z Zᵀ / p (through
    `gram_panel`, hence K2 on the card), then (K + λI) α = y_c and K α + ȳ."""
    K = gram_panel(X, device=X.device) / X.shape[1]
    mu = y.mean()
    A = K + lam * torch.eye(K.shape[0], dtype=K.dtype, device=K.device)
    alpha = torch.linalg.solve(A, y - mu)
    return K @ alpha + mu


def entry(device="cuda"):
    """(fn, example_args): the GBLUP forward step and inputs on `device`,
    drawn from the same numpy seed as the JAX entry point."""
    rng = np.random.default_rng(0)
    X = as_tensor(rng.random((256, 2048)), device, torch.float32)
    y = as_tensor(rng.normal(size=256), device, torch.float32)
    lam = torch.tensor(0.1, dtype=torch.float32, device=X.device)
    return gblup_forward, (X, y, lam)
