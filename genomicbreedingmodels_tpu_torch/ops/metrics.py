"""Prediction-accuracy metrics (reference src/metrics.jl:115-128).

Port of genomicbreedingmodels_tpu/ops/metrics.py. The public `metrics` dict
is computed in f64 numpy on the host, copied as is: these are O(n)
reductions, and the CV self-consistency invariant (across-entry cor equals
per-entry-table cor to 1e-10) is unreachable in f32. `metrics_vector` is the
f32 torch version for callers whose predictions are already on the device.
Zero-variance guards return 0.0 as the reference does.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..device import as_tensor

__all__ = ["metrics", "metrics_vector", "METRIC_NAMES", "pearson_correlation"]

METRIC_NAMES = ("cor", "mad", "msd", "rmsd", "nrmsd", "euc", "jac", "tvar", "h²", "r²")


def _var(x: torch.Tensor) -> torch.Tensor:
    # Sample variance (ddof=1) to match Julia's Statistics.var.
    return ((x - x.mean()) ** 2).sum() / max(x.shape[0] - 1, 1)


def metrics_vector(y_true, y_pred, device="cuda") -> torch.Tensor:
    """The 10 metrics of `METRIC_NAMES` as one f32 tensor on `device`."""
    y_true = as_tensor(y_true, device, torch.float32)
    y_pred = as_tensor(y_pred, device, torch.float32)
    d = y_true - y_pred
    var_t, var_p, var_d = _var(y_true), _var(y_pred), _var(d)
    low_var = (var_t < 1e-10) | (var_p < 1e-10)

    mt, mp = y_true.mean(), y_pred.mean()
    cov = ((y_true - mt) * (y_pred - mp)).sum()
    denom = torch.sqrt(((y_true - mt) ** 2).sum() * ((y_pred - mp) ** 2).sum())
    cor = torch.where(low_var, 0.0, cov / torch.where(denom == 0, 1.0, denom))

    mad = d.abs().mean()
    msd = (d**2).mean()
    rmsd = torch.sqrt(msd)
    rng = y_true.max() - y_true.min()
    nrmsd = rmsd / torch.where(rng == 0, 1.0, rng)
    euc = torch.sqrt((d**2).sum())
    jac_den = torch.maximum(y_true, y_pred).sum()
    jac = 1.0 - torch.minimum(y_true, y_pred).sum() / torch.where(jac_den == 0, 1.0, jac_den)
    tvar = 0.5 * d.abs().sum()

    h2_den = var_p + var_d
    h2 = torch.where(h2_den >= 1e-20, var_p / torch.where(h2_den == 0, 1.0, h2_den), 0.0)
    h2 = torch.clamp(torch.where(low_var, 0.0, h2), 0.0, 1.0)
    r2 = torch.where(low_var, 0.0, 1.0 - var_d / torch.where(var_t == 0, 1.0, var_t))
    return torch.stack([cor, mad, msd, rmsd, nrmsd, euc, jac, tvar, h2, r2])


def metrics(y_true, y_pred) -> Dict[str, float]:
    """Dict of all metrics; mirrors reference `metrics` (src/metrics.jl:115).

    Computed in f64 on the host so the CV self-consistency invariant
    (src/cross_validation.jl:263-264, 1e-10) holds exactly.
    """
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    if y_true.shape != y_pred.shape:
        raise ValueError("y_true and y_pred must have the same shape")
    n = y_true.shape[0]
    d = y_true - y_pred
    ddof = 1 if n > 1 else 0
    var_t = float(np.var(y_true, ddof=ddof))
    var_p = float(np.var(y_pred, ddof=ddof))
    var_d = float(np.var(d, ddof=ddof))
    low_var = (var_t < 1e-10) or (var_p < 1e-10)

    mt, mp = y_true.mean(), y_pred.mean()
    cov = float(np.sum((y_true - mt) * (y_pred - mp)))
    denom = float(np.sqrt(np.sum((y_true - mt) ** 2) * np.sum((y_pred - mp) ** 2)))
    cor = 0.0 if low_var else cov / (denom if denom != 0 else 1.0)

    mad = float(np.mean(np.abs(d)))
    msd = float(np.mean(d**2))
    rmsd = float(np.sqrt(msd))
    rng = float(y_true.max() - y_true.min()) if n else 0.0
    nrmsd = rmsd / (rng if rng != 0 else 1.0)
    euc = float(np.sqrt(np.sum(d**2)))
    jac_den = float(np.sum(np.maximum(y_true, y_pred)))
    jac = 1.0 - float(np.sum(np.minimum(y_true, y_pred))) / (jac_den if jac_den != 0 else 1.0)
    tvar = 0.5 * float(np.sum(np.abs(d)))

    h2_den = var_p + var_d
    h2 = var_p / (h2_den if h2_den != 0 else 1.0) if h2_den >= 1e-20 else 0.0
    h2 = min(max(0.0 if low_var else h2, 0.0), 1.0)
    r2 = 0.0 if low_var else 1.0 - var_d / (var_t if var_t != 0 else 1.0)
    out = dict(zip(METRIC_NAMES, (cor, mad, msd, rmsd, nrmsd, euc, jac, tvar, h2, r2)))
    out["h2"] = out["h²"]
    out["r2"] = out["r²"]
    return out


def pearson_correlation(y_true, y_pred) -> float:
    return metrics(y_true, y_pred)["cor"]
