"""Endofunctions on [0,1] for epistasis feature engineering, torch port of
genomicbreedingmodels_tpu/features/endofunctions.py (reference
src/transformation.jl:9-54).

Each function maps allele frequencies (or pairs) back into [0,1] so
transformed features remain valid frequencies. They take numpy arrays (and
Python numbers), computed in numpy's float64 so feature round-trips are
exact, or torch tensors, computed in torch on the tensor's device. The
registry names are the JAX package's, so feature-name strings cross between
the two packages.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "square",
    "invoneplus",
    "log10epsdivlog10eps",
    "mult",
    "addnorm",
    "raise_",
    "FUNCTION_REGISTRY",
    "UNARY_DEFAULTS",
    "BINARY_DEFAULTS",
    "registry_name",
]

_EPS = np.finfo(np.float64).eps
_LOG10_EPS = float(np.log10(_EPS))


def _m(x):
    """Backend dispatch: torch for tensors, numpy for host arrays and numbers."""
    return torch if isinstance(x, torch.Tensor) else np


def square(x):
    return x * x


def invoneplus(x):
    return 1.0 / (1.0 + x)


def log10epsdivlog10eps(x):
    # (log10(x + eps)) / log10(eps); both input and output in [0, 1].
    return _m(x).log10(x + _EPS) / _LOG10_EPS


def mult(x, y):
    return x * y


def addnorm(x, y):
    return (x + y) / 2.0


def raise_(x, y):
    return torch.pow(x, y) if _m(x) is torch else np.power(x, y)


# `raise` is a Python keyword; the registry keeps the reference's name so
# feature-name strings round-trip against reference-produced names.
FUNCTION_REGISTRY = {
    "square": square,
    "invoneplus": invoneplus,
    "log10epsdivlog10eps": log10epsdivlog10eps,
    "mult": mult,
    "addnorm": addnorm,
    "raise": raise_,
    "raise_": raise_,
}

UNARY_DEFAULTS = (square, invoneplus, log10epsdivlog10eps)
BINARY_DEFAULTS = (mult, addnorm, raise_)


def registry_name(f) -> str:
    name = getattr(f, "__name__", str(f))
    return "raise" if name == "raise_" else name
