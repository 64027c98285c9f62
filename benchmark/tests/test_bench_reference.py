"""The plain references agree with the port at a tiny size on the CPU, and
import nothing of the program or of JAX."""

import subprocess
import sys

import numpy as np
import pytest
import torch
from conftest import BENCH

from reference import cv as ref_cv
from reference import gblup as ref_gblup


@pytest.mark.parametrize("panel", ["int8", "bf16"])
def test_gblup_reference_agrees_with_the_port(panel):
    from genomicbreedingmodels_tpu_torch.ops.chol import gblup_solve_lower
    from genomicbreedingmodels_tpu_torch.ops.grm import gram_dosage_lower, gram_panel

    gen = torch.Generator().manual_seed(3)
    n, p = 80, 2000
    if panel == "int8":
        X = torch.randint(0, 3, (n, p), dtype=torch.int8, generator=gen)
        K = gram_dosage_lower(X, ploidy=2, device="cpu")
        ploidy = 2
    else:
        X = torch.rand((n, p), dtype=torch.bfloat16, generator=gen)
        K = gram_panel(X, device="cpu")
        ploidy = None
    Y = torch.randn((3, n), generator=gen)
    lam = 0.1 * p
    prog = torch.stack([gblup_solve_lower(K, y, lam) for y in Y])
    want = ref_gblup.gebv(X, Y, lam, ploidy)
    assert float(ref_gblup.gap(prog, want).max()) < 1e-5
    # the control is another computation of the same: close, not equal
    ctl = ref_gblup.gebv_control(X, Y, lam, ploidy)
    assert float(ref_gblup.gap(ctl, want).max()) < 0.1


def test_cv_reference_agrees_with_the_port():
    from genomicbreedingmodels_tpu_torch.cv.batched import cvbulk_batched

    import harness

    route = harness.route_module({"route": "cv_sweep"})
    rng = np.random.default_rng(4)
    n, p = 120, 600
    freq = rng.uniform(size=(n, p)).astype(np.float32)
    beta = rng.normal(size=p) * (rng.uniform(size=p) < 0.02)
    y = freq @ beta
    y = y + rng.normal(size=n) * y.std()
    genomes, phenomes = route._panel(freq)
    cvs, _ = cvbulk_batched(genomes, phenomes(y), models=("ridge", "gblup", "lasso"), n_replications=2,
                            n_folds=3, seed=99, store_effects=False, device="cpu")
    sol = ref_cv.solve(torch.from_numpy(freq), y, 99, 2, 3, ["ridge", "gblup", "lasso"])
    got = ref_cv.compare(route.records(cvs), sol, y)
    assert got["records_differ"] == 0 and got["metric_gap"] < 1e-12
    assert got["pred_gap"] < 1e-4
    assert got["lasso_pred_gap"] < 1e-2


def test_cv_folds_follow_the_seed():
    a = ref_cv.folds(7, 50, 2, 5)
    b = ref_cv.folds(7, 50, 2, 5)
    assert len(a) == 10 and all(np.array_equal(x[2], y[2]) for x, y in zip(a, b))
    labels = np.random.default_rng(7).integers(1, 6, size=50)
    assert np.array_equal(a[0][2], labels != 1)


def test_references_import_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); import reference.gblup, reference.cv, counts.gblup_refit; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'genomicbreedingmodels_tpu', 'genomicbreedingmodels_tpu_torch')]; "
            "print(bad); sys.exit(1 if bad else 0)") % str(BENCH)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
