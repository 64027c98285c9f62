"""A run whose timed path is broken underneath reports `correct: false`: the
faults each cell can have, planted in the program at a tiny size on the CPU
(the look for a chip skipped). One chip: no exchange between chips to leave
out."""

import numpy as np
import pytest
from conftest import run_tiny


def _refit_fault(monkeypatch, fault):
    from genomicbreedingmodels_tpu_torch.ops import chol, grm

    solve, gram = chol.gblup_solve_lower, grm.gram_dosage_lower
    calls = {"n": 0}
    if fault == "state_unchanged":  # the refit hands back its input phenotypes
        monkeypatch.setattr(chol, "gblup_solve_lower", lambda K, y, lam, nb=None: y.clone())
    elif fault == "half_the_batch":  # the Gram over half the loci, scaled up
        def half(D, ploidy=2, device="cuda"):
            return 2.0 * gram(D[:, : D.shape[1] // 2].contiguous(), ploidy=ploidy, device=device)
        monkeypatch.setattr(grm, "gram_dosage_lower", half)
    elif fault == "answer_altered":  # one GEBV of one refit moved where it is made
        def altered(K, y, lam, nb=None):
            g = solve(K, y, lam, nb)
            calls["n"] += 1
            if calls["n"] == 7:
                g[3] += 1e-3 * g.abs().max()
            return g
        monkeypatch.setattr(chol, "gblup_solve_lower", altered)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch", "answer_altered"])
def test_refit_faults_are_not_correct(fault, monkeypatch):
    rc, res = run_tiny("gblup-refit-int8", seconds=0.3)
    assert rc == 0 and res["correct"] is True
    _refit_fault(monkeypatch, fault)
    rc, res = run_tiny("gblup-refit-int8", seconds=0.3)
    assert rc == 0 and res["correct"] is False and res["checks"]["gebv_gap"]["value"] > 1e-4


def _cv_fault(monkeypatch, fault):
    from genomicbreedingmodels_tpu_torch.cv import batched

    solve_folds, cvbulk = batched._solve_folds, batched.cvbulk_batched
    if fault == "state_unchanged":  # every fold's fit left at its start: zero effects
        def unchanged(K, y, W, grid, kind):
            preds, gammas, crit = solve_folds(K, y, W, grid, kind)
            mean = ((W * y).sum(1) / W.sum(1)).cpu().numpy()
            return np.broadcast_to(mean[:, None, None], preds.shape).copy(), gammas * 0, crit
        monkeypatch.setattr(batched, "_solve_folds", unchanged)
    elif fault == "half_the_batch":  # half of every fold's training rows left out
        def half(K, y, W, grid, kind):
            W2 = W.clone()
            W2[:, ::2] = 0.0
            return solve_folds(K, y, W2, grid, kind)
        monkeypatch.setattr(batched, "_solve_folds", half)
    elif fault == "answer_altered":  # one prediction of one fold moved where it is emitted
        def altered(*a, **kw):
            cvs, notes = cvbulk(*a, **kw)
            cvs[4].y_pred = cvs[4].y_pred.copy()
            cvs[4].y_pred[0] += 0.05 * np.std(cvs[4].y_true)
            return cvs, notes
        monkeypatch.setattr(batched, "cvbulk_batched", altered)
    elif fault == "lasso_choice_altered":  # the lasso's GCV read backwards: the worst λ is chosen
        lasso_folds = batched._lasso_folds

        def backwards(*a, **kw):
            preds, B, crit, b0 = lasso_folds(*a, **kw)
            return preds, B, -crit, b0
        monkeypatch.setattr(batched, "_lasso_folds", backwards)
    elif fault == "folds_changed":  # the fold labels drawn from another seed
        def other_seed(*a, seed=42, **kw):
            return cvbulk(*a, seed=seed + 1, **kw)
        monkeypatch.setattr(batched, "cvbulk_batched", other_seed)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch", "answer_altered", "lasso_choice_altered",
                                   "folds_changed"])
def test_cv_faults_are_not_correct(fault, monkeypatch):
    _cv_fault(monkeypatch, fault)
    rc, res = run_tiny("cv-linear", seconds=0.3)
    assert rc == 0 and res["correct"] is False, res["checks"]
    if fault == "lasso_choice_altered":
        gap = res["checks"]["lasso_choice_regret"]
        assert gap["value"] > gap["limit"], res["checks"]
