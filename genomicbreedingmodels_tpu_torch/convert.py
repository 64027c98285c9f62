"""Carry state across from the JAX package.

Each function reads the JAX package's object by attribute, as numpy arrays,
and builds the port's dataclass. Nothing here imports the JAX package: the
caller hands the object over. A `Fit` fitted by the JAX `gblup` then predicts
through the port's `predict` as it does through the JAX one.
"""

from __future__ import annotations

import numpy as np

from .core.structs import Fit, Genomes, Phenomes

__all__ = ["fit_from_reference", "genomes_from_reference", "phenomes_from_reference"]


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
        extras=dict(obj.extras),
    )
