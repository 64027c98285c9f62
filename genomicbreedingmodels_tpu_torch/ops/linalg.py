"""Linear-algebra ops of the model zoo, torch port.

Only `affine_predict` (genomicbreedingmodels_tpu/ops/linalg.py:46-60) is
ported so far: the GEMV behind `predict` for every linear model.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import as_tensor

__all__ = ["affine_predict"]


def affine_predict(G, idx_e, idx_l, b0: float, b, device="cuda") -> np.ndarray:
    """ŷ = b0 + G[idx_e, idx_l] @ b as one f32 GEMV on `device` (f64 numpy out)."""
    sub = as_tensor(np.asarray(G)[np.ix_(idx_e, idx_l)], device, torch.float32)
    bt = as_tensor(b, device, torch.float32)
    out = torch.mv(sub, bt) + torch.tensor(b0, dtype=torch.float32, device=sub.device)
    return out.cpu().numpy().astype(np.float64)
