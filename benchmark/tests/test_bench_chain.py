"""The CV route judges a Gibbs chain by its states: each checked BayesC call
is re-run with its chain in one-sweep segments, its first sweep (from the
reference's own start) and two drawn from the seed are replayed in float64
against the program's own states, and its predictions
against the mean of its own post-burn-in states (`reference/bayes.py`). On
the CPU at the tiny size of `tiny/cv-bayes.json` (n 96, p 600, 3 folds, 6
sweeps), where the chain runs K3's plain grouped version; the `cv-bayes`
configuration and traffic files ride on the cv-linear cell as overrides
until the cell is registered."""

import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from conftest import BENCH, TINY, run_tiny

import control
import harness
from reference import bayes

CONFIG = {**json.loads((BENCH / "configs" / "cv-bayesc-2048x32768.json").read_text()), **TINY["cv-bayes"][0]}
TRAFFIC = {**json.loads((BENCH / "traffic" / "cv-bayes.json").read_text()), **TINY["cv-bayes"][1]}
CHAIN_NUMBERS = {"records_differ", "metric_gap", "rerun_differs", "chain_unreachable", "sweeps_differ",
                 "posterior_pred_gap", "step_b_gap", "step_flips", "step_scalar_gap"}


def run_bayes(seed: int = 7, config=None, traffic=None):
    return run_tiny("cv-linear", seed=seed, config={**CONFIG, **(config or {})}, traffic={**TRAFFIC, **(traffic or {})})


def _ctx(seed: int):
    """The cell set up, through a window, and released, as a run leaves it
    before its check."""
    cell = harness.resolve_cell(harness.load_manifest(), "cv-linear")[0]
    route = harness.route_module(TRAFFIC)
    ctx = harness.Ctx(cell, dict(CONFIG), dict(TRAFFIC), seed, 0.3, False, torch.device("cpu"), time.perf_counter())
    route.setup(ctx)
    route.window(ctx)
    route.release(ctx)
    return route, ctx


@pytest.mark.parametrize("seed", [7, 3_000_000_019])
def test_program_agrees_with_the_chain_reference(seed):
    rc, res = run_bayes(seed)
    assert rc == 0 and res is not None and res["failed"] == 0
    assert set(res["checks"]) == CHAIN_NUMBERS and set(TRAFFIC["limits"]) == CHAIN_NUMBERS
    assert res["correct"] is True, res["checks"]
    got = {k: v["value"] for k, v in res["checks"].items()}
    assert got["rerun_differs"] == 0 and got["step_flips"] == 0 and got["sweeps_differ"] == 0
    assert 0 < got["step_b_gap"] < 1e-5 and 0 < got["posterior_pred_gap"] < 1e-5  # float32 against float64


def test_segmented_rerun_is_the_call_bit_for_bit():
    route, ctx = _ctx(11)
    (i, cvs), = route._checked_calls(ctx)
    rec, again = route._rerun(ctx, i, "bayesc")
    assert route._differ(route.records(cvs), again) == 0 and len(again) == 3
    assert rec["n_sweeps"] == CONFIG["mcmc_n_iter"]
    burn = CONFIG["mcmc_n_burnin"]
    ts = [s["t"] for s in rec["steps"]]  # the first sweep, then one in burn-in (maybe the first) and one after
    assert ts[0] == 0 and ts == sorted(ts) and ts[-1] >= burn and all(t < burn for t in ts[:-1]) and len(ts) <= 3
    assert rec["post_b"].shape == (CONFIG["mcmc_n_iter"] - burn, 3, 774) and rec["post_mu"].shape[1] == 3
    for s in rec["steps"]:  # each replayed sweep moved the state and its generators
        assert not torch.equal(s["before"]["b"], s["after"]["b"])
        assert not torch.equal(s["before"]["gens"], s["after"]["gens"])
    moved = route.records(cvs)  # one prediction one ulp off shows
    moved[2]["pred_val"] = np.nextafter(moved[2]["pred_val"], np.inf)
    assert route._differ(moved, again) == 1


def test_reference_replays_its_own_float64_sweep_exactly():
    """The reference's vectorised replay, conditioned on a sweep that the
    reference itself ran group after group in float64 with its own choices,
    finds the same effects, no flip and the same scalars."""
    route, ctx = _ctx(13)
    (i, cvs), = route._checked_calls(ctx)
    st, cfg = ctx.state, ctx.config
    cond, _, _ = route._chains(ctx, i, ["bayesc"], route.records(cvs))
    y = st.traits[i]
    sol = bayes.solve(st.X, y, st.fold_seeds[i], cfg["n_replications"], cfg["n_folds"], ["bayesc"], config=cfg,
                      chain=cond)
    sz = sol["sizes"]
    valid = (torch.arange(sz["p_pad"]) < sz["p"]).double()
    Xf = bayes._fold_panels(sol["X"], sol["masks"], sz["bs"])
    C = Xf.transpose(-1, -2) @ Xf
    w = sol["masks"].double()

    def exact(before):  # the residual from y, mu and b, as the replay takes it
        b = before["b"].double().view(len(w), sz["n_blocks"], 1, sz["bs"])
        r = (sol["y"] - before["mu"].double()[:, None]) * w - (Xf * b).sum((1, 3))
        return {**before, "r": r}

    after = [bayes.control_sweep(Xf, C, sol["y"], w, exact(bayes._before(s, sol["y"], w, sol["hyper"], sz["p_pad"])),
                                 sol["hyper"], sz, valid, low=False) for s in cond["bayesc"]["steps"]]
    got = bayes.step_readings(sol, after)
    assert got["step_flips"] == 0 and got["flip_margin"] == 0
    assert got["step_b_gap"] < 1e-10 and got["step_scalar_gap"] < 1e-10, got


def _chain_fault(monkeypatch, fault):
    import importlib

    from genomicbreedingmodels_tpu_torch.cv import batched

    bayesian = importlib.import_module("genomicbreedingmodels_tpu_torch.models.bayesian")
    scan, fold_chains, cvbulk = bayesian.group_scan, bayesian._fold_chains, batched.cvbulk_batched
    if fault == "state_unchanged":  # every block update hands back the effects it was given
        def unchanged(W, const, gum, Cb, u, b_blk, *a):
            return torch.zeros_like(b_blk), b_blk.clone(), torch.zeros_like(b_blk)
        monkeypatch.setattr(bayesian, "group_scan", unchanged)
    elif fault == "half_the_folds":  # half of the fold chains run, the others given their mean
        def half(X, y, masks, seeds, *a, **kw):
            k = (len(masks) + 1) // 2
            out = fold_chains(X, y, masks[:k], seeds[:k], *a, **kw)
            return tuple(np.concatenate([o, np.repeat(o.mean(0, keepdims=True), len(masks) - k, 0)])
                         if o.ndim and o.shape[0] == k else o for o in out)
        monkeypatch.setattr(bayesian, "_fold_chains", half)
    elif fault == "prediction_altered":  # one prediction of one fold moved where it is emitted
        def altered(*a, **kw):
            cvs, notes = cvbulk(*a, **kw)
            cvs[1].y_pred = cvs[1].y_pred.copy()
            cvs[1].y_pred[0] += 0.01 * np.std(cvs[1].y_true)
            return cvs, notes
        monkeypatch.setattr(batched, "cvbulk_batched", altered)
    elif fault == "folds_changed":  # the fold labels drawn from another seed
        monkeypatch.setattr(batched, "cvbulk_batched", lambda *a, seed=42, **kw: cvbulk(*a, seed=seed + 1, **kw))
    elif fault == "sweep_skipped":  # the chain runs one sweep fewer than asked
        monkeypatch.setattr(bayesian, "_fold_chains",
                            lambda X, y, masks, seeds, model, n_iter, *a, **kw: fold_chains(
                                X, y, masks, seeds, model, n_iter - 1, *a, **kw))
    elif fault == "burnin_accumulated":  # the posterior mean takes the burn-in sweeps too
        monkeypatch.setattr(bayesian, "_fold_chains",
                            lambda X, y, masks, seeds, model, n_iter, n_burnin, *a, **kw: fold_chains(
                                X, y, masks, seeds, model, n_iter, 0, *a, **kw))
    elif fault == "start_altered":  # the chains start from twice the residual variance
        start = bayesian._initial_state

        def doubled(*a, **kw):
            state = list(start(*a, **kw))
            state[3] = state[3] * 2.0
            return tuple(state)
        monkeypatch.setattr(bayesian, "_initial_state", doubled)
    elif fault == "gumbel_reversed":  # the pattern chosen by the Gumbel noise read backwards
        monkeypatch.setattr(bayesian, "group_scan", lambda W, const, gum, *a: scan(W, const, -gum, *a))


FAULTS = {"state_unchanged": "step_flips", "half_the_folds": "posterior_pred_gap",
          "prediction_altered": "posterior_pred_gap", "folds_changed": "records_differ",
          "sweep_skipped": "sweeps_differ", "burnin_accumulated": "posterior_pred_gap", "start_altered": "step_b_gap",
          "gumbel_reversed": "step_flips"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_chain_faults_are_not_correct(fault, monkeypatch):
    _chain_fault(monkeypatch, fault)
    rc, res = run_bayes()
    assert rc == 0 and res["correct"] is False, res["checks"]
    caught = res["checks"][FAULTS[fault]]
    assert not caught["value"] <= caught["limit"], res["checks"]


@pytest.mark.parametrize("how", ["name_gone", "segments_gone"])
def test_an_unreachable_chain_is_a_number(how, monkeypatch):
    import importlib

    route, ctx = _ctx(17)
    bayesian = importlib.import_module("genomicbreedingmodels_tpu_torch.models.bayesian")
    if how == "name_gone":
        monkeypatch.delattr(bayesian, "_gibbs_chain")
    else:  # a chain that takes no `iters`, `state_in` or `return_state`
        inner = bayesian._gibbs_chain
        monkeypatch.setattr(bayesian, "_gibbs_chain", lambda *a, **kw: inner(*a, **kw))
    got = route.check(ctx)
    assert got["chain_unreachable"] == (1.0, 0) and got["records_differ"][0] == 0
    assert "step_b_gap" not in got


def test_bayes_control_fails():
    got = {side: nums for _, side, nums in control.readings("cv-linear", [19], [19], 0.3, "cpu", CONFIG, TRAFFIC)}
    limits = TRAFFIC["limits"]
    assert all(v <= limits[k] for k, v in got["program"].items()), got
    fails = [k for k, v in got["control"].items() if not v <= limits[k]]
    assert "step_b_gap" in fails and "metric_gap" in fails, got


def test_a_cpu_chain_run_loads_no_jax():
    code = (
        "import sys, time; t0 = time.perf_counter(); sys.path[:0] = [%r, %r]; "
        "import test_bench_chain as t, harness; rc, res = t.run_bayes(); "
        "print('FORBIDDEN', harness.forbidden_loaded(), res['correct']); sys.exit(rc)"
    ) % (str(BENCH / "tests"), str(BENCH))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=BENCH.parent)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "FORBIDDEN [] True" in r.stdout
