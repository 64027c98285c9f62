"""genomicbreedingmodels_tpu_torch — PyTorch/CUDA port of genomicbreedingmodels_tpu.

The port lives beside the JAX package, which stays the reference it is held
against, and keeps its file and function names so each counterpart is found
by path. It imports torch and numpy, never jax and never the JAX package.

Covered so far: the GBLUP main path — data layer, simulators, GRM (exact int8
dosage Gram K1 and f32/bf16 Gram K2, hand-written CUDA kernels for Hopper),
the lower-triangle GBLUP solve, REML variance components, `gblup`, `predict`
and `metrics`; the Bayesian alphabet (`gibbs_regression`, `bglr`,
`bayesian` and the eight model functions), whose indicator models run the
grouped Gibbs block update K3 as a hand-written CUDA kernel; the linear zoo
(`ols`, `ridge`, `lasso`), the MLP, and cross-validation (`validate`,
`cvbulk` and its population modes, `cvbulk_batched` for ridge/gblup/lasso,
`tabularise`/`summarise`); the GWAS suite (`gwasprep`, `gwasols`,
`gwaslmm`, `gwasreml`) and multi-trait / multi-environment GBLUP
(`gblup_multitrait`, `gblup_multitrait_cov`, `gblup_multienv`,
`mtgblup_em`); the fold-batched Bayesian CV chains (`gibbs_cv_folds`, the
eight Bayesian names of `cvbulk_batched`), whose indicator models run K3 for
every fold in one launch per block; and the epistasis feature engine (the
six endofunctions, `transform1`, `transform2`, `epistasisfeatures`,
`reconstitutefeatures`, `parse_feature_name`); the out-of-core path (the
TSV / PLINK .bed / VCF codecs with their native C++ library,
`BedShardStreamer`, `grm_from_bed` and `gblup_from_bed`, whose complete .bed
shards reach K1, and the trapezoid-pieces CG of `ops/pieces.py`), the
plots and the command line (`python -m genomicbreedingmodels_tpu_torch`).
Every public entry point takes `device=` (default "cuda"); `device="cpu"`
runs the kernels' plain PyTorch versions.
"""

from .core.structs import (
    CV,
    Fit,
    Genomes,
    Phenomes,
    SimulatedEffects,
    Trials,
    checkdims,
    clone,
    slice_genomes,
    slice_phenomes,
)
from .core.simulation import extract_phenomes, simulate_genomes, simulate_trials
from .core.grm import grm_ploidy_aware, grm_simple, infer_ploidy
from .ops.metrics import metrics
from .prediction import extractxyetc, mean_impute, predict
from .models.gwas import gwaslmm, gwasols, gwasprep, gwasreml, loglikreml
from .models.gblup import gblup, gblup_multitrait, reml_variance_components
from .models.multitrait import gblup_multienv, gblup_multitrait_cov, mtgblup_em
from .models.bayesian import (
    BAYESIAN_MODELS,
    bayesa,
    bayesb,
    bayesc,
    bayesian,
    bayesian_lasso,
    bayesian_lasso_pi,
    bayesian_ridge,
    bayest,
    bayestpi,
    bglr,
    gibbs_cv_folds,
    gibbs_regression,
)
from .models.linear import lasso, ols, ridge
from .models.mlp import mlp
from .core.tabularise import summarise, tabularise
from .cv.harness import (
    MODEL_REGISTRY,
    cvbulk,
    cvdispatch,
    cvleaveonepopulationout,
    cvmultithread,
    cvpairwisepopulation,
    cvperpopulation,
    validate,
)
from .cv.batched import cvbulk_batched
from .features.endofunctions import (
    addnorm,
    invoneplus,
    log10epsdivlog10eps,
    mult,
    raise_,
    square,
)
from .features.transform import (
    epistasisfeatures,
    parse_feature_name,
    reconstitutefeatures,
    transform1,
    transform2,
)
from .io import (
    read_bed,
    read_genomes_tsv,
    read_phenomes_tsv,
    read_vcf,
    write_bed,
    write_genomes_tsv,
    write_phenomes_tsv,
)
from .streaming import BedShardStreamer, gblup_from_bed, grm_from_bed
from .plots import manhattan_data, plot_cv, plot_manhattan
from .utils.devcache import clear_device_caches
from .kernels._build import LAUNCHES, reset_launches

__version__ = "0.1.0"

__all__ = [
    "CV",
    "Fit",
    "Genomes",
    "Phenomes",
    "SimulatedEffects",
    "Trials",
    "checkdims",
    "clone",
    "slice_genomes",
    "slice_phenomes",
    "simulate_genomes",
    "simulate_trials",
    "extract_phenomes",
    "grm_simple",
    "grm_ploidy_aware",
    "infer_ploidy",
    "metrics",
    "extractxyetc",
    "mean_impute",
    "predict",
    "gblup",
    "gblup_multitrait",
    "gblup_multitrait_cov",
    "gblup_multienv",
    "mtgblup_em",
    "reml_variance_components",
    "gwasprep",
    "gwasols",
    "gwaslmm",
    "gwasreml",
    "loglikreml",
    "gibbs_regression",
    "gibbs_cv_folds",
    "bglr",
    "bayesian",
    "bayesa",
    "bayesb",
    "bayesc",
    "bayesian_ridge",
    "bayesian_lasso",
    "bayesian_lasso_pi",
    "bayest",
    "bayestpi",
    "BAYESIAN_MODELS",
    "ols",
    "ridge",
    "lasso",
    "mlp",
    "MODEL_REGISTRY",
    "validate",
    "cvdispatch",
    "cvmultithread",
    "cvbulk",
    "cvbulk_batched",
    "cvperpopulation",
    "cvpairwisepopulation",
    "cvleaveonepopulationout",
    "tabularise",
    "summarise",
    "square",
    "invoneplus",
    "log10epsdivlog10eps",
    "mult",
    "addnorm",
    "raise_",
    "transform1",
    "transform2",
    "epistasisfeatures",
    "reconstitutefeatures",
    "parse_feature_name",
    "read_genomes_tsv",
    "write_genomes_tsv",
    "read_phenomes_tsv",
    "write_phenomes_tsv",
    "read_bed",
    "write_bed",
    "read_vcf",
    "BedShardStreamer",
    "grm_from_bed",
    "gblup_from_bed",
    "manhattan_data",
    "plot_manhattan",
    "plot_cv",
    "clear_device_caches",
    "LAUNCHES",
    "reset_launches",
]
