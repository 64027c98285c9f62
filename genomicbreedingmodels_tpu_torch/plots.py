"""GWAS / CV plotting (parity with GenomicBreedingCore's `plot(fit, dist)`,
used by the reference at src/gwas.jl:252, :394, :608).

Copied from genomicbreedingmodels_tpu/plots.py: host code over the port's
Fit and CV structs. pandas and matplotlib are imported inside the functions,
never when the module is imported.

`manhattan_data` converts a GWAS Fit's per-marker test statistics into
-log10(p) with genome coordinates parsed from the reference-format locus
names ('chrom<TAB>pos<TAB>alleles<TAB>allele'); `plot_manhattan` renders it
with matplotlib when a save path is given. `plot_cv` summarizes a CV sweep's
accuracy per model/trait. Plotting is optional — every function returns the
underlying dataframe so headless pipelines can skip rendering.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .core.structs import CV, Fit

__all__ = ["manhattan_data", "plot_manhattan", "plot_cv"]


def _normal_logsf(z: np.ndarray) -> np.ndarray:
    """log10 two-sided normal p-value, stable for large |z|."""
    z = np.abs(z)
    # p = erfc(z / sqrt(2)); use scipy-free asymptotic-safe evaluation.
    try:
        from scipy.special import log_ndtr  # type: ignore

        return (log_ndtr(-z) + np.log(2.0)) / np.log(10.0)
    except Exception:
        from numpy import errstate

        with errstate(divide="ignore", over="ignore"):
            from math import erfc

            p = np.array([max(erfc(v / np.sqrt(2.0)), 1e-300) for v in z])
        return np.log10(p)


def manhattan_data(fit: Fit, dist: str = "normal", df: Optional[int] = None):
    """(chrom, pos, stat, neg_log10_p) per marker from a GWAS Fit.

    `dist`: 'normal' (z-scores, gwaslmm/gwasreml) or 't' (t-stats, gwasols —
    the reference uses TDist(n-1), src/gwas.jl:252). Returns a pandas
    DataFrame sorted by (chrom, pos).
    """
    import pandas as pd

    stats = np.asarray(fit.b_hat, dtype=np.float64)
    labels = [str(x) for x in fit.b_hat_labels]
    chroms, poss = [], []
    for name in labels:
        parts = name.split("\t")
        if len(parts) >= 2:
            chroms.append(parts[0])
            try:
                poss.append(int(parts[1]))
            except ValueError:
                poss.append(0)
        else:
            chroms.append("chrom_0")
            poss.append(0)
    if dist == "normal":
        neg_log10_p = -_normal_logsf(stats)
    elif dist == "t":
        n = max(len(fit.entries), 3)
        d = df if df is not None else n - 1
        try:
            from scipy import stats as sps  # type: ignore

            p = 2.0 * sps.t.sf(np.abs(stats), d)
            neg_log10_p = -np.log10(np.maximum(p, 1e-300))
        except Exception:
            # t ~ normal for the d.o.f. sizes in play; acceptable fallback.
            neg_log10_p = -_normal_logsf(stats)
    else:
        raise ValueError(f"unknown dist {dist!r}; choose 'normal' or 't'")
    out = pd.DataFrame(
        {
            "locus": labels,
            "chrom": chroms,
            "pos": poss,
            "stat": stats,
            "neg_log10_p": neg_log10_p,
        }
    )
    return out.sort_values(["chrom", "pos"], kind="stable").reset_index(drop=True)


def plot_manhattan(
    fit: Fit,
    dist: str = "normal",
    save_path: Optional[str] = None,
    significance: float = 5e-8,
):
    """Manhattan plot; returns the dataframe, writes a PNG when `save_path`
    is given."""
    df = manhattan_data(fit, dist=dist)
    if save_path is not None:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(10, 3.2), dpi=120)
        x0 = 0
        ticks, tick_labels = [], []
        for i, (chrom, sub) in enumerate(df.groupby("chrom", sort=True)):
            x = x0 + np.arange(len(sub))
            ax.scatter(x, sub["neg_log10_p"], s=4, alpha=0.7,
                       color=["#3b5ba5", "#e0893d"][i % 2], linewidths=0)
            ticks.append(x0 + len(sub) / 2)
            tick_labels.append(str(chrom).replace("chrom_", ""))
            x0 += len(sub)
        ax.axhline(-np.log10(significance), color="red", lw=0.8, ls="--")
        ax.set_xticks(ticks, tick_labels)
        ax.set_xlabel("chromosome")
        ax.set_ylabel("-log10(p)")
        ax.set_title(f"{fit.model} — {fit.trait}")
        fig.tight_layout()
        fig.savefig(save_path)
        plt.close(fig)
    return df


def plot_cv(cvs: Sequence[CV], metric: str = "cor", save_path: Optional[str] = None):
    """Per-(model, trait) accuracy summary of a CV sweep; optional box plot."""
    import pandas as pd

    rows = [
        {
            "model": cv.fit.model,
            "trait": cv.fit.trait,
            "replication": cv.replication,
            "fold": cv.fold,
            metric: cv.metrics[metric],
        }
        for cv in cvs
    ]
    df = pd.DataFrame(rows)
    if save_path is not None and len(df):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(6, 3.2), dpi=120)
        groups = [(k, g[metric].to_numpy()) for k, g in df.groupby(["model", "trait"])]
        ax.boxplot([g for _, g in groups],
                   tick_labels=["\n".join(map(str, k)) for k, _ in groups])
        ax.set_ylabel(metric)
        ax.set_title("cross-validation accuracy")
        fig.tight_layout()
        fig.savefig(save_path)
        plt.close(fig)
    return df
