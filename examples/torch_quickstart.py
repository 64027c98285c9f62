"""Quickstart on the PyTorch port: simulate a breeding panel, fit the model
zoo, cross-validate. The twin of examples/quickstart.py.

Run: python examples/torch_quickstart.py [--device cuda|cpu]
(`--device` defaults to cuda, and asking for cuda without a card raises.)

The CV summary is the mean and sample std of `cor` per trait over the CV
jobs, as the JAX example's pandas `describe()` gives them, computed with
numpy so that the example runs without pandas.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import genomicbreedingmodels_tpu_torch as gbm  # noqa: E402
from genomicbreedingmodels_tpu_torch.device import resolve_device  # noqa: E402

MODELS = ("ols", "ridge", "lasso", "gblup", "bayesa", "mlp")


def main(device="cuda", n: int = 200, l: int = 2_000, n_train: int = 160,
         n_replications: int = 2, n_folds: int = 5) -> dict:
    """Runs the quickstart on `device`; returns what it prints: per model the
    in-sample and held-out cor, the CV jobs' (trait, model, replication,
    fold) tags, validation entries and cor, and the per-trait mean and std."""
    resolve_device(device)
    # 1. Simulate a founder-cross panel (kinship + LD) and multi-env trials.
    genomes = gbm.simulate_genomes(n=n, l=l, n_populations=2, seed=42)
    trials, effects = gbm.simulate_trials(
        genomes,
        f_add_dom_epi=np.array([[0.5, 0.05, 0.05]]),  # additive/dom/epi variance
        n_years=2,
        n_replications=2,
        seed=42,
    )
    phenomes = gbm.extract_phenomes(trials)

    # 2. Fit each model on the first n_train entries, predict the rest.
    train, test = list(range(n_train)), list(range(n_train, n))
    y = np.asarray(phenomes.phenotypes[:, 0], float)
    in_sample, held_out = {}, {}
    for name in MODELS:
        fit = getattr(gbm, name)(genomes=genomes, phenomes=phenomes, idx_entries=train,
                                 device=device)
        y_hat = gbm.predict(fit, genomes, idx_entries=test, device=device)
        in_sample[name] = float(fit.metrics["cor"])
        held_out[name] = float(np.corrcoef(y_hat, y[test])[0, 1])
        print(f"{name:8s} in-sample cor={in_sample[name]:.3f} "
              f"held-out cor={held_out[name]:.3f}")

    # 3. Replicated k-fold CV (batched engine) + summary table.
    cvs, notes = gbm.cvbulk_batched(genomes, phenomes, n_replications=n_replications,
                                    n_folds=n_folds, device=device)
    summary = {}
    for trait in sorted({cv.fit.trait for cv in cvs}):
        cor = np.array([cv.metrics.get("cor", np.nan) for cv in cvs if cv.fit.trait == trait])
        summary[trait] = (float(np.mean(cor)), float(np.std(cor, ddof=1)) if len(cor) > 1
                          else float("nan"))
    print("\nCV accuracy (batched ridge engine):")
    width = max([5] + [len(t) for t in summary])
    print(f"{'':{width}s}  {'mean':>8s}  {'std':>8s}")
    print(f"{'trait':{width + 20}s}")
    for trait, (mean, std) in summary.items():
        print(f"{trait:{width}s}  {mean:8.6f}  {std:8.6f}")
    return dict(
        in_sample_cor=in_sample,
        held_out_cor=held_out,
        cv_tags=[(cv.fit.trait, cv.fit.model, cv.replication, cv.fold) for cv in cvs],
        cv_entries=[list(cv.validation_entries) for cv in cvs],
        cv_cor=[float(cv.metrics.get("cor", np.nan)) for cv in cvs],
        cv_summary=summary,
        notes=list(notes),
    )


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    main(device=ap.parse_args().device)
