"""Framework configuration, copied from genomicbreedingmodels_tpu/utils/config.py
(numpy/stdlib only). A single dataclass with `GBM_<UPPER_NAME>` environment
overrides, so production runs can be tuned without code changes; the field
names, defaults and variables are the JAX package's."""

from __future__ import annotations

import os
from dataclasses import dataclass, fields

__all__ = ["GBMConfig", "get_config", "set_config", "reset_config"]


@dataclass
class GBMConfig:
    # numerics
    compute_dtype: str = "float32"  # device compute dtype for model solves
    gram_block_cols: int = 262_144  # GRM column-block streaming width
    # MCMC (reference defaults n_iter=1500, n_burnin=500, src/linear.jl:446-447)
    mcmc_block_size: int = 256
    mcmc_n_iter: int = 1_500
    mcmc_n_burnin: int = 500
    # Within-block update of the indicator models (BayesB/C, BLπ, BayesTπ;
    # BL rides the grouped machinery degenerated to the single all-ones
    # pattern): "grouped" = the exact collapsed 2^K-pattern draw
    # (K = mcmc_group_size) in plain torch; "pallas" = the same update as one
    # hand-written CUDA kernel per block (kernels/gibbs_group.py; K <= 8);
    # "scalar" = the one-marker-at-a-time oracle; "auto" = the kernel on a
    # CUDA device for the indicator models with block_size <= 1024 and
    # K <= 8, "grouped" everywhere else.
    mcmc_indicator_update: str = "auto"
    mcmc_group_size: int = 6
    # λ paths
    n_lambda: int = 100
    lambda_min_ratio: float = 0.01
    path_cv_folds: int = 10
    # CV harness
    cv_workers: int = 1
    # REML: log-lattice seed + projected-Newton steps
    reml_grid: int = 8
    reml_newton: int = 12

    @classmethod
    def from_env(cls) -> "GBMConfig":
        """Override any field via GBM_<UPPER_NAME> environment variables."""
        kwargs = {}
        for f in fields(cls):
            env = os.environ.get(f"GBM_{f.name.upper()}")
            if env is not None:
                typ = type(f.default)
                kwargs[f.name] = typ(env)
        return cls(**kwargs)


_config: GBMConfig | None = None


def get_config() -> GBMConfig:
    global _config
    if _config is None:
        _config = GBMConfig.from_env()
    return _config


def set_config(cfg: GBMConfig) -> None:
    global _config
    _config = cfg


def reset_config() -> None:
    """Drop the cached config so the next get_config() re-reads the env."""
    global _config
    _config = None
