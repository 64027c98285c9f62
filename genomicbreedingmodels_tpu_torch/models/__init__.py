from .gwas import gwaslmm, gwasols, gwasprep, gwasreml, loglikreml
from .gblup import gblup, gblup_multitrait, reml_variance_components
from .multitrait import gblup_multienv, gblup_multitrait_cov, mtgblup_em
from .bayesian import (
    bglr, bayesa, bayesb, bayesc, bayesian, bayesian_ridge, bayesian_lasso, bayesian_lasso_pi,
    bayest, bayestpi, gibbs_regression,
)
from .linear import lasso, ols, ridge
from .mlp import mlp
