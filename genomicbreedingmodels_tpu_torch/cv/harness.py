"""Cross-validation harness, torch port of genomicbreedingmodels_tpu/cv/harness.py
(reference src/cross_validation.jl).

`validate` (:49-84), the job dispatcher (`cvdispatch`, reference
`cvmultithread!` :151-206), bulk replicated k-fold CV (`cvbulk` :267-421) and
its population-aware variants (:501-595, :659-828, :901-1061).

Jobs carry integer indices resolved once, and a small host-side executor
runs them: one after another, or in a thread pool with `n_workers > 1`. Every
job runs on a torch device: `devices[i % D]` for job i, so jobs fan out
round-robin over several cards, and share one card when there is one. The
models reach the kernels themselves (K1/K2 through `gblup`'s GRM, K2 in bf16
through `ridge`, K3 through the indicator models). Fold-assignment semantics
(random labels, NOT an exact partition), skip rules and note strings mirror
the reference (src/cross_validation.jl:358-371) and the JAX package's numpy
RNG stream, so both packages build the same jobs for a seed.
"""

from __future__ import annotations

import concurrent.futures as _futures
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..core.structs import CV, Fit, Genomes, Phenomes
from ..device import resolve_device
from ..ops.metrics import metrics
from ..prediction import predict
from ..models.linear import lasso, ols, ridge
from ..models.bayesian import bayesa, bayesb, bayesc, bayesian_lasso, bayesian_lasso_pi, bayesian_ridge, bayest, bayestpi
from ..models.gblup import gblup
from ..models.mlp import mlp
from ..utils.logging import StageTimer, get_logger

__all__ = [
    "MODEL_REGISTRY",
    "validate",
    "cvdispatch",
    "cvmultithread",
    "cvbulk",
    "cvperpopulation",
    "cvpairwisepopulation",
    "cvleaveonepopulationout",
]

MODEL_REGISTRY: Dict[str, Callable[..., Fit]] = {
    "ols": ols,
    "ridge": ridge,
    "lasso": lasso,
    "bayesa": bayesa,
    "bayesb": bayesb,
    "bayesc": bayesc,
    "bayesian_ridge": bayesian_ridge,
    "bayesian_lasso": bayesian_lasso,
    "bayesian_lasso_pi": bayesian_lasso_pi,
    "bayest": bayest,
    "bayestpi": bayestpi,
    "gblup": gblup,
    "mlp": mlp,
}

# A model is a registry name or a callable taking the registry functions'
# keywords, `device=` included.
ModelSpec = Union[str, Callable[..., Fit]]


def _resolve_model(model: ModelSpec) -> Tuple[str, Callable[..., Fit]]:
    if callable(model):
        name = getattr(model, "__name__", str(model))
        return name, model
    if model not in MODEL_REGISTRY:
        raise ValueError(
            f"{model!r} is not a valid genomic prediction model; choose from "
            + ", ".join(sorted(MODEL_REGISTRY))
        )
    return model, MODEL_REGISTRY[model]


def validate(
    fit: Fit,
    genomes: Genomes,
    phenomes: Phenomes,
    idx_validation: Sequence[int],
    replication: str = "",
    fold: str = "",
    device="cuda",
) -> CV:
    """Score a fitted model on held-out entries (reference :49-84), predicting
    on `device`. Raises on train/validation entry overlap (data leakage)."""
    idx_validation = np.asarray(idx_validation, dtype=np.int64)
    leakage = np.intersect1d(fit.entries, phenomes.entries[idx_validation])
    if len(leakage) > 0:
        raise ValueError(
            "data leakage between training and validation sets, entries: "
            + ", ".join(map(str, leakage[:5]))
        )
    idx_trait = phenomes.trait_index(fit.trait)
    phi = phenomes.phenotypes[idx_validation, idx_trait]
    keep = np.flatnonzero(np.isfinite(phi))
    rows = idx_validation[keep]
    y_true = phi[keep]
    y_pred = predict(fit, genomes, idx_entries=rows, device=device)
    perf = metrics(y_true, y_pred)
    cv = CV(
        replication=replication,
        fold=fold,
        fit=fit,
        validation_populations=phenomes.populations[rows],
        validation_entries=phenomes.entries[rows],
        y_true=y_true,
        y_pred=y_pred,
        metrics=perf,
    )
    if not cv.checkdims():
        raise ValueError("CV struct is corrupted")
    return cv


def _run_job(job, genomes: Genomes, phenomes: Phenomes, device="cuda") -> Optional[CV]:
    name, fn = _resolve_model(job["model"])
    try:
        fit = fn(
            genomes=genomes,
            phenomes=phenomes,
            idx_entries=job["idx_training"],
            idx_loci_alleles=job.get("idx_loci_alleles"),
            idx_trait=job["idx_trait"],
            verbose=False,
            device=device,
        )
        return validate(
            fit,
            genomes,
            phenomes,
            idx_validation=job["idx_validation"],
            replication=job.get("replication", ""),
            fold=job.get("fold", ""),
            device=device,
        )
    except Exception as err:  # mirror reference warn-and-continue (:186-197)
        warnings.warn(
            f"unexpected model-fitting error for model {name!r} "
            f"(replication={job.get('replication', '')!r}, fold={job.get('fold', '')!r}): {err}"
        )
        return None


def cvdispatch(
    jobs: List[dict],
    genomes: Genomes,
    phenomes: Phenomes,
    n_workers: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    devices: Optional[Sequence] = None,
    verbose: bool = False,
    device="cuda",
) -> List[CV]:
    """Run CV jobs (the reference's `cvmultithread!`, :151-206); failed jobs
    are warned about and dropped rather than aborting the sweep. With
    `checkpoint_path`, finished jobs are appended to a resume ledger and
    skipped on restart (new capability vs the reference).

    Placement: job i runs on `devices[i % D]`; `devices` defaults to
    [`device`]. With `n_workers > 1` the jobs run in a thread pool: on several
    cards they fan out round-robin, on one card they share it (the host work
    of one job overlaps the device work of another). Results keep the jobs'
    order either way.
    """
    if n_workers is None:
        # Flows from GBMConfig (env override GBM_CV_WORKERS).
        from ..utils.config import get_config

        n_workers = get_config().cv_workers
    devs = [resolve_device(d) for d in (devices if devices is not None else [device])]
    ckpt = None
    sigs: List[Optional[str]] = [None] * len(jobs)
    if checkpoint_path is not None:
        from ..utils.checkpoint import CVCheckpoint, job_signature

        ckpt = CVCheckpoint(checkpoint_path)
        sigs = [job_signature(job) for job in jobs]

    results: List[Optional[CV]] = [None] * len(jobs)
    timer = StageTimer()

    def run_one(i: int, job: dict) -> Optional[CV]:
        if ckpt is not None and sigs[i] in ckpt:
            return ckpt.get(sigs[i])
        name = job["model"] if isinstance(job["model"], str) else getattr(job["model"], "__name__", "model")
        with timer.stage(name):
            cv = _run_job(job, genomes, phenomes, device=devs[i % len(devs)])
        if ckpt is not None and cv is not None:
            ckpt.record(sigs[i], cv)
        return cv

    if n_workers <= 1:
        for i, job in enumerate(jobs):
            results[i] = run_one(i, job)
    else:
        with _futures.ThreadPoolExecutor(max_workers=n_workers) as pool:
            futs = {pool.submit(run_one, i, job): i for i, job in enumerate(jobs)}
            for fut in _futures.as_completed(futs):
                results[futs[fut]] = fut.result()
    if verbose and timer.totals:
        get_logger().info("cvdispatch per-model wall-clock: %s", timer.summary())
    return [r for r in results if r is not None]


def cvmultithread(jobs, genomes, phenomes, models_vector=None, verbose: bool = False, device="cuda"):
    """Name-compatible alias for the reference `cvmultithread!`."""
    if models_vector is not None:
        for job, m in zip(jobs, models_vector):
            job["model"] = m
    return cvdispatch(jobs, genomes, phenomes, verbose=verbose, device=device)


def _common_checks(genomes: Genomes, phenomes: Phenomes, models) -> None:
    if not genomes.checkdims():
        raise ValueError("the Genomes struct is corrupted")
    if not phenomes.checkdims():
        raise ValueError("the Phenomes struct is corrupted")
    if not np.array_equal(genomes.entries, phenomes.entries):
        raise ValueError("genomes and phenomes must be merged to have consistent entries")
    if len(models) < 1:
        raise ValueError("no models were specified")
    for m in models:
        _resolve_model(m)


def _cvbulk_jobs(genomes, phenomes, models, n_replications, n_folds, seed):
    """cvbulk's jobs and notes: per trait and replication one draw of fold
    labels (uniform with replacement), per fold one job per model."""
    n = genomes.n
    rng = np.random.default_rng(seed)
    jobs: List[dict] = []
    notes: List[str] = []
    for idx_trait, trait in enumerate(phenomes.traits.tolist()):
        for i in range(1, n_replications + 1):
            fold_labels = rng.integers(1, n_folds + 1, size=n)
            phi = phenomes.phenotypes[:, idx_trait]
            finite = np.isfinite(phi)
            for j in range(1, n_folds + 1):
                idx_training = np.flatnonzero((fold_labels != j) & finite)
                idx_validation = np.flatnonzero((fold_labels == j) & finite)
                if len(idx_training) < 2 or len(idx_validation) < 1:
                    notes.append(";".join(["too_many_missing", trait, f"replication_{i}", f"fold_{j}"]))
                    continue
                if np.var(phi[idx_training], ddof=1) < 1e-20:
                    notes.append(";".join(["zero_variance", trait, f"replication_{i}", f"fold_{j}"]))
                    continue
                for model in models:
                    jobs.append(
                        dict(
                            model=model,
                            idx_trait=idx_trait,
                            idx_training=idx_training,
                            idx_validation=idx_validation,
                            idx_loci_alleles=None,
                            replication=f"replication_{i}",
                            fold=f"fold_{j}",
                        )
                    )
    return jobs, notes


def cvbulk(
    genomes: Genomes,
    phenomes: Phenomes,
    models: Sequence[ModelSpec] = ("ridge",),
    n_replications: int = 5,
    n_folds: int = 5,
    seed: int = 42,
    n_workers: Optional[int] = None,
    verbose: bool = False,
    device="cuda",
) -> Tuple[List[CV], List[str]]:
    """Replicated k-fold CV across all traits, ignoring population structure
    (reference :267-421). Fold labels are drawn uniformly with replacement —
    a random assignment, not an exact partition — matching the reference
    (src/cross_validation.jl:358).
    """
    _common_checks(genomes, phenomes, models)
    n = genomes.n
    if not (1 <= n_folds <= n):
        raise ValueError(f"n_folds={n_folds} out of bounds (1..{n})")
    if not (1 <= n_replications <= 100):
        raise ValueError(f"n_replications={n_replications} out of bounds (1..100)")
    jobs, notes = _cvbulk_jobs(genomes, phenomes, models, n_replications, n_folds, seed)
    cvs = cvdispatch(jobs, genomes, phenomes, n_workers=n_workers, verbose=verbose, device=device)
    return cvs, notes


def cvperpopulation(
    genomes: Genomes,
    phenomes: Phenomes,
    models: Sequence[ModelSpec] = ("ridge",),
    n_replications: int = 5,
    n_folds: int = 5,
    seed: int = 42,
    n_workers: Optional[int] = None,
    verbose: bool = False,
    device="cuda",
) -> Tuple[List[CV], List[str]]:
    """Within-population k-fold CV: slice per population, run cvbulk on each
    slice (reference :501-595)."""
    _common_checks(genomes, phenomes, models)
    cvs: List[CV] = []
    notes: List[str] = []
    for population in sorted(set(genomes.populations.tolist())):
        idx_entries = np.flatnonzero(phenomes.populations == population)
        try:
            c, nts = cvbulk(
                genomes.slice(idx_entries=idx_entries),
                phenomes.slice(idx_entries=idx_entries),
                models=models,
                n_replications=n_replications,
                n_folds=n_folds,
                seed=seed,
                n_workers=n_workers,
                verbose=verbose,
                device=device,
            )
            cvs.extend(c)
            notes.extend(nts)
        except Exception as err:  # one population's failure leaves the others' results
            warnings.warn(f"per-population cross-validation error for {population!r}: {err}")
    return cvs, notes


def _population_pair_jobs(genomes, phenomes, models, pairs_mode: str):
    """Job builder shared by pairwise and leave-one-population-out CV."""
    populations = sorted(set(genomes.populations.tolist()))
    jobs: List[dict] = []
    notes: List[str] = []
    for idx_trait, trait in enumerate(phenomes.traits.tolist()):
        phi = phenomes.phenotypes[:, idx_trait]
        finite = np.isfinite(phi)
        if pairs_mode == "pairwise":
            combos = [
                (np.asarray(phenomes.populations == a), np.asarray(phenomes.populations == b), a, b)
                for a in populations
                for b in populations
                if a != b
            ]
        else:  # leave-one-population-out
            combos = [
                (
                    np.asarray(phenomes.populations != b),
                    np.asarray(phenomes.populations == b),
                    ";".join([x for x in populations if x != b]),
                    b,
                )
                for b in populations
            ]
        for train_mask, val_mask, train_name, val_name in combos:
            idx_training = np.flatnonzero(train_mask & finite)
            idx_validation = np.flatnonzero(val_mask & finite)
            if len(idx_training) < 2 or len(idx_validation) < 1:
                notes.append(
                    ";".join(["too_many_missing", trait, f"training: {train_name}", f"validation: {val_name}"])
                )
                continue
            if np.var(phi[idx_training], ddof=1) < 1e-20:
                notes.append(
                    ";".join(["zero_variance", trait, f"training: {train_name}", f"validation: {val_name}"])
                )
                continue
            for model in models:
                jobs.append(
                    dict(
                        model=model,
                        idx_trait=idx_trait,
                        idx_training=idx_training,
                        idx_validation=idx_validation,
                        idx_loci_alleles=None,
                        replication="",
                        fold="",
                    )
                )
    return jobs, notes


def cvpairwisepopulation(
    genomes: Genomes,
    phenomes: Phenomes,
    models: Sequence[ModelSpec] = ("ridge",),
    n_replications: int = 5,  # unused; API symmetry with the reference (:663-665)
    n_folds: int = 5,
    seed: int = 42,
    n_workers: Optional[int] = None,
    verbose: bool = False,
    device="cuda",
) -> Tuple[List[CV], List[str]]:
    """Train on population A, validate on population B, for every ordered pair
    A != B (reference :659-828)."""
    _common_checks(genomes, phenomes, models)
    jobs, notes = _population_pair_jobs(genomes, phenomes, models, "pairwise")
    cvs = cvdispatch(jobs, genomes, phenomes, n_workers=n_workers, verbose=verbose, device=device)
    return cvs, notes


def cvleaveonepopulationout(
    genomes: Genomes,
    phenomes: Phenomes,
    models: Sequence[ModelSpec] = ("ridge",),
    n_replications: int = 5,  # unused; API symmetry
    n_folds: int = 5,
    seed: int = 42,
    n_workers: Optional[int] = None,
    verbose: bool = False,
    device="cuda",
) -> Tuple[List[CV], List[str]]:
    """Validation = one population, training = all others, per trait
    (reference :901-1061)."""
    _common_checks(genomes, phenomes, models)
    jobs, notes = _population_pair_jobs(genomes, phenomes, models, "lopo")
    cvs = cvdispatch(jobs, genomes, phenomes, n_workers=n_workers, verbose=verbose, device=device)
    return cvs, notes
