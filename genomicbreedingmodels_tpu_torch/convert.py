"""Carry state across from the JAX package.

Each function reads the JAX package's object by attribute, as numpy arrays,
and builds the port's dataclass. Nothing here imports the JAX package: the
caller hands the object over. A `Fit` fitted by the JAX `gblup` or `mlp`
then predicts through the port's `predict` as it does through the JAX one,
and a list of JAX `CV`s goes through the port's `tabularise`.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.structs import CV, Fit, Genomes, Phenomes, Trials
from .device import resolve_device

__all__ = [
    "cv_from_reference",
    "fit_from_reference",
    "genomes_from_reference",
    "mlp_from_params",
    "phenomes_from_reference",
    "trials_from_reference",
]


def genomes_from_reference(obj) -> Genomes:
    return Genomes(
        entries=np.asarray(obj.entries),
        populations=np.asarray(obj.populations),
        loci_alleles=np.asarray(obj.loci_alleles),
        allele_frequencies=np.asarray(obj.allele_frequencies),
        mask=np.asarray(obj.mask),
    )


def phenomes_from_reference(obj) -> Phenomes:
    return Phenomes(
        entries=np.asarray(obj.entries),
        populations=np.asarray(obj.populations),
        traits=np.asarray(obj.traits),
        phenotypes=np.asarray(obj.phenotypes),
        mask=np.asarray(obj.mask),
    )


def trials_from_reference(obj) -> Trials:
    return Trials(
        entries=np.asarray(obj.entries),
        populations=np.asarray(obj.populations),
        years=np.asarray(obj.years),
        seasons=np.asarray(obj.seasons),
        sites=np.asarray(obj.sites),
        replications=np.asarray(obj.replications),
        traits=np.asarray(obj.traits),
        phenotypes=np.asarray(obj.phenotypes),
    )


def _extra(v):
    """An `extras` value as the port holds it: arrays (the multi-trait t×t
    covariances) as numpy copies, dicts (the multi-environment effects) as
    dicts of converted values, anything else as is."""
    if isinstance(v, dict):
        return {k: _extra(x) for k, x in v.items()}
    if hasattr(v, "__array__") and np.ndim(v) > 0:
        return np.array(v)
    return v


def fit_from_reference(obj) -> Fit:
    return Fit(
        model=str(obj.model),
        b_hat=np.asarray(obj.b_hat),
        b_hat_labels=np.asarray(obj.b_hat_labels),
        trait=str(obj.trait),
        entries=np.asarray(obj.entries),
        populations=np.asarray(obj.populations),
        y_true=np.asarray(obj.y_true),
        y_pred=np.asarray(obj.y_pred),
        metrics=dict(obj.metrics),
        extras={k: _extra(v) for k, v in obj.extras.items()},
    )


def cv_from_reference(obj) -> CV:
    return CV(
        replication=str(obj.replication),
        fold=str(obj.fold),
        fit=fit_from_reference(obj.fit),
        validation_populations=np.asarray(obj.validation_populations),
        validation_entries=np.asarray(obj.validation_entries),
        y_true=np.asarray(obj.y_true),
        y_pred=np.asarray(obj.y_pred),
        metrics=dict(obj.metrics),
    )


def mlp_from_params(params, device="cuda"):
    """The port's `models.mlp.MLP` holding `params`, the JAX layout of
    `fit.extras["params"]`: a list of (W (din, dout), b) pairs, numpy or any
    array type numpy reads."""
    from .models.mlp import MLP

    pairs = [(np.array(W, dtype=np.float32), np.array(b, dtype=np.float32)) for W, b in params]
    sizes = [pairs[0][0].shape[0], *[W.shape[1] for W, _ in pairs]]
    net = MLP(sizes).to(resolve_device(device))
    with torch.no_grad():
        for layer, (W, b) in zip(net.layers, pairs):
            layer.weight.copy_(torch.from_numpy(W.T.copy()))
            layer.bias.copy_(torch.from_numpy(b))
    net.eval()
    return net
