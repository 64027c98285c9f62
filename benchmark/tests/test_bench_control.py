"""Each cell's control, the reference one precision below the configuration's
in the program's place, fails the cell's check at a size a test run holds.

The bf16 panel's float8 control and the lasso's float8 bulk fail on the CPU
at a tiny size; the TF32 parts (the int8 refit's factor and solves, the CV
Gram and fold products) exist only on the card, so the cases at the cells'
own sizes carry the `cuda` marker."""

import pytest
from conftest import TINY

import control
import harness


def _control_fails(workload, device, tiny=True):
    cfg, tr = TINY[workload] if tiny else ({}, {})
    limits = harness.resolve_cell(harness.load_manifest(), workload)[2]["limits"]
    got = {side: nums for _, side, nums in control.readings(workload, [11], [11], 0.3, device, cfg, tr)}
    prog_ok = all(v <= limits[k] for k, v in got["program"].items() if k in limits)
    ctl_fails = [k for k, v in got["control"].items() if v > limits[k]]
    return prog_ok, ctl_fails, got


def test_freq_control_fails():
    ok, fails, got = _control_fails("gblup-refit-freq", "cpu")
    assert ok and fails == ["gebv_gap"], got


def test_cv_control_fails():
    ok, fails, got = _control_fails("cv-linear", "cpu")
    assert ok and "lasso_pred_gap" in fails and "metric_gap" in fails, got


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["gblup-refit-int8", "gblup-refit-freq"])
def test_refit_control_fails_on_the_card(workload, card):
    """At the cell's own size: the limits were set there."""
    ok, fails, got = _control_fails(workload, "cuda", tiny=False)
    assert ok and fails == ["gebv_gap"], got


@pytest.mark.cuda
def test_cv_control_fails_on_the_card(card):
    ok, fails, got = _control_fails("cv-linear", "cuda", tiny=False)
    assert ok and {"pred_gap", "lasso_pred_gap", "metric_gap"} <= set(fails), got
