"""The CV route takes every model family of `cvbulk_batched`: a Bayesian
configuration runs through `cv_sweep` with new data alone (configuration
keys and a traffic file's limits, here as overrides), its chain length from
the configuration, and its records judged by the reference that names its
model, or counted under `records_differ` where none does. On the CPU at a
tiny size."""

import sys
import time

import numpy as np
import pytest
import torch
from conftest import TINY, run_tiny

import harness

BAYESC = {"models": ["bayesc"], "n_loci": 300, "mcmc_n_iter": 4, "mcmc_n_burnin": 1}

STUB = '''
"""A stand-in reference of BayesC CV records: it holds every record whose
model it names and reads the gap the test sets."""

MODELS = ("bayesc",)
POOLED = ()
GAP = {gap!r}
CONFIGS = []


def solve(X, y, seed, n_replications, n_folds, models, control=False, config=None):
    CONFIGS.append(config)
    return {{"folds": n_replications * n_folds, "models": list(models)}}


def records_of_control(solution, y):
    return []


def compare(records, solution, y):
    held = {{(r["rep"], r["fold"]) for r in records if r["model"] in solution["models"] and r["lam"] is None}}
    return {{"records_differ": float(solution["folds"] - len(held)), "stub_gap": GAP}}
'''


@pytest.fixture
def bayesc_unheld(monkeypatch):
    """`reference/bayes.py` set aside, so that no reference holds BayesC."""
    from reference import bayes

    monkeypatch.setattr(bayes, "MODELS", ())


def _stub_reference(tmp_path, monkeypatch, gap: float, name: str):
    """A reference module `name` found beside `benchmark/reference/`'s, from a
    directory outside the benchmark."""
    import reference

    (tmp_path / f"{name}.py").write_text(STUB.format(gap=gap))
    monkeypatch.setattr(reference, "__path__", [*reference.__path__, str(tmp_path)])
    monkeypatch.delitem(sys.modules, f"reference.{name}", raising=False)
    return lambda: sys.modules[f"reference.{name}"]


@pytest.mark.parametrize("gap", [0.1, 0.9])
def test_bayesc_cell_is_judged_by_the_reference_that_names_it(gap, tmp_path, monkeypatch, bayesc_unheld):
    stub = _stub_reference(tmp_path, monkeypatch, gap, f"stub_bayes_{int(gap * 10)}")
    rc, res = run_tiny("cv-linear", config=BAYESC, traffic={"limits": {"records_differ": 0, "stub_gap": 0.5}})
    assert rc == 0 and res is not None
    assert set(res["metrics"]) == {"cv_fits_per_s", "setup_s"} and res["metrics"]["cv_fits_per_s"]["value"] > 0
    assert res["failed"] == 0
    assert res["checks"] == {"records_differ": {"value": 0.0, "limit": 0}, "stub_gap": {"value": gap, "limit": 0.5}}
    assert res["correct"] is (gap <= 0.5)
    assert stub().CONFIGS and all(c["mcmc_n_iter"] == 4 for c in stub().CONFIGS)  # handed the configuration


def test_bayesc_cell_without_a_reference_is_not_correct(bayesc_unheld):
    rc, res = run_tiny("cv-linear", config=BAYESC)
    assert rc == 0 and res is not None and "cv_fits_per_s" in res["metrics"]
    assert res["correct"] is False
    assert res["checks"]["records_differ"]["value"] == 15  # 3 replications x 5 folds, none held
    assert set(res["checks"]) == {"records_differ"}


def test_chain_length_reaches_cvbulk_batched(monkeypatch, bayesc_unheld):
    from genomicbreedingmodels_tpu_torch.cv import batched

    seen = []
    chains = batched.gibbs_cv_folds

    def recording(*a, **kw):  # records the length asked for, runs a short chain where none was
        seen.append((kw["n_iter"], kw["n_burnin"]))
        return chains(*a, **{**kw, "n_iter": kw["n_iter"] or 4, "n_burnin": kw["n_burnin"] or 1})

    monkeypatch.setattr(batched, "gibbs_cv_folds", recording)
    rc, res = run_tiny("cv-linear", config={**BAYESC, "mcmc_n_iter": 6, "mcmc_n_burnin": 2})
    assert rc == 0 and seen and set(seen) == {(6, 2)}
    seen.clear()
    rc, res = run_tiny("cv-linear", config={k: v for k, v in BAYESC.items() if not k.startswith("mcmc_")})
    assert rc == 0 and seen and set(seen) == {(None, None)}  # without the keys, the program's own length


def _tiny_cv_ctx(seed: int):
    """The cv-linear cell at its tiny size, set up and through a window of
    several calls, two of them checked."""
    cell, config, traffic = harness.resolve_cell(harness.load_manifest(), "cv-linear")
    config.update(TINY["cv-linear"][0])
    traffic.update({**TINY["cv-linear"][1], "check_calls": 2})
    route = harness.route_module(traffic)
    ctx = harness.Ctx(cell, config, traffic, seed, 2.0, False, torch.device("cpu"), time.perf_counter())
    route.setup(ctx)
    route.window(ctx)
    route.release(ctx)
    assert ctx.window["requests"] >= 2
    return route, ctx


@pytest.mark.parametrize("control", [False, True])
def test_cv_linear_numbers_are_the_single_reference_s(control):
    """Every record sent to `reference/cv.py` alone, as the route did before
    it dispatched by model, gives the same numbers, bit for bit."""
    from reference import cv as ref

    route, ctx = _tiny_cv_ctx(3_000_000_019)
    st, cfg = ctx.state, ctx.config
    per_call = {}
    for i, cvs in route._checked_calls(ctx):
        args = (st.X, st.traits[i], st.fold_seeds[i], cfg["n_replications"], cfg["n_folds"], cfg["models"])
        sol = ref.solve(*args)
        recs = ref.records_of_control(ref.solve(*args, control=True), st.traits[i]) if control else route.records(cvs)
        for k, v in ref.compare(recs, sol, st.traits[i]).items():
            per_call.setdefault(k, []).append(v)
    want = {k: (sum(v) / len(v) if k in ref.POOLED else max(v)) for k, v in per_call.items()}
    got = route.control(ctx) if control else {k: v for k, (v, _) in route.check(ctx).items()}
    assert list(got) == list(want) and got == want


def test_references_are_found_by_the_models_they_name(tmp_path, monkeypatch):
    from reference import bayes as ref_bayes
    from reference import cv as ref_cv

    assert harness.references(["ridge", "gblup", "lasso", "bayesc", "bayesa"]) == {
        "ridge": ref_cv, "gblup": ref_cv, "lasso": ref_cv, "bayesc": ref_bayes}
    import reference

    (tmp_path / "stub_twice.py").write_text('MODELS = ("lasso",)\n')
    monkeypatch.setattr(reference, "__path__", [*reference.__path__, str(tmp_path)])
    monkeypatch.delitem(sys.modules, "reference.stub_twice", raising=False)
    with pytest.raises(ValueError, match="lasso"):
        harness.references(["lasso"])


def test_a_nan_number_is_not_passed_over():
    route = harness.route_module({"route": "cv_sweep"})
    assert np.isnan(route._worst([0.1, float("nan")])) and np.isnan(route._worst([float("nan"), 0.1]))
    assert route._worst([0.1, 0.3]) == 0.3
