from . import chol, grm, linalg, metrics
