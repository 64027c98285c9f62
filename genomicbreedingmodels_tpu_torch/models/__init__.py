from .gwas import loglikreml
from .gblup import gblup, reml_variance_components
from .bayesian import (
    bglr, bayesa, bayesb, bayesc, bayesian, bayesian_ridge, bayesian_lasso, bayesian_lasso_pi,
    bayest, bayestpi, gibbs_regression,
)
from .linear import lasso, ols, ridge
from .mlp import mlp
