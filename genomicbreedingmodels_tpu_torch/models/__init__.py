from .gwas import loglikreml
from .gblup import gblup, reml_variance_components
