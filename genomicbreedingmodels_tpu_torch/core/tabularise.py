"""Flatten CV results to data frames (GenomicBreedingCore `tabularise` /
`summarise` equivalents, used by the reference at src/cross_validation.jl:141,
492-498). Copied from genomicbreedingmodels_tpu/core/tabularise.py.

pandas is imported inside the two functions, never when the module or the
package is imported: a machine without pandas runs the rest of the port.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .structs import CV

__all__ = ["tabularise", "summarise"]

_METRIC_COLS = ["cor", "mad", "msd", "rmsd", "nrmsd", "euc", "jac", "tvar", "h2", "r2"]


def _training_population(cv: CV) -> str:
    return ";".join(sorted(set(cv.fit.populations.tolist())))


def _validation_population(cv: CV) -> str:
    return ";".join(sorted(set(cv.validation_populations.tolist())))


def tabularise(cvs: List[CV]) -> Tuple["pd.DataFrame", "pd.DataFrame"]:  # noqa: F821
    """Returns (df_across_entries, df_per_entry).

    df_across_entries: one row per CV job with across-entry metrics.
    df_per_entry: one row per validation entry with y_true / y_pred.
    """
    import pandas as pd

    across_rows = []
    per_rows = []
    for cv in cvs:
        base = dict(
            training_population=_training_population(cv),
            validation_population=_validation_population(cv),
            trait=cv.fit.trait,
            model=cv.fit.model,
            replication=cv.replication,
            fold=cv.fold,
        )
        row = dict(base)
        for k in _METRIC_COLS:
            row[k] = cv.metrics.get(k, np.nan)
        row["n_validation"] = len(cv.validation_entries)
        across_rows.append(row)
        for e, pop, yt, yp in zip(
            cv.validation_entries.tolist(),
            cv.validation_populations.tolist(),
            cv.y_true.tolist(),
            cv.y_pred.tolist(),
        ):
            per = dict(base)
            per.update(entry=e, population=pop, validation_population=pop, y_true=yt, y_pred=yp)
            per_rows.append(per)
    return pd.DataFrame(across_rows), pd.DataFrame(per_rows)


def summarise(cvs: List[CV]) -> Tuple["pd.DataFrame", "pd.DataFrame"]:  # noqa: F821
    """Returns (summary_across, summary_per_entry).

    summary_across: mean/std of each metric grouped by
    (trait, model, training_population, validation_population).
    summary_per_entry: per-entry mean y_true / y_pred / squared error grouped
    by (entry, trait, model).
    """
    df_across, df_per = tabularise(cvs)
    if len(df_across) == 0:
        return df_across, df_per
    keys = ["trait", "model", "training_population", "validation_population"]
    summary_across = (
        df_across.groupby(keys, as_index=False)
        .agg(
            cor_mean=("cor", "mean"),
            cor_std=("cor", "std"),
            rmsd_mean=("rmsd", "mean"),
            rmsd_std=("rmsd", "std"),
            h2_mean=("h2", "mean"),
            r2_mean=("r2", "mean"),
            n_jobs=("cor", "size"),
        )
    )
    df_per = df_per.assign(sq_err=(df_per["y_true"] - df_per["y_pred"]) ** 2)
    summary_per_entry = (
        df_per.groupby(["entry", "population", "trait", "model"], as_index=False)
        .agg(
            y_true_mean=("y_true", "mean"),
            y_pred_mean=("y_pred", "mean"),
            sq_err_mean=("sq_err", "mean"),
            n=("y_true", "size"),
        )
    )
    return summary_across, summary_per_entry
