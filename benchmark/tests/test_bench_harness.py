"""The manifest resolves by name, keeps to the benchmark's contract, and a run
prints the result line the contract asks for."""

import json
import math
import re
import shutil
import subprocess
import sys

import pytest
from conftest import BENCH, TINY, run_tiny

import harness

MANIFEST = harness.load_manifest()
WORKLOADS = [w["name"] for w in MANIFEST["workloads"]]
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_workload_resolves_by_name(workload):
    cell, config, traffic = harness.resolve_cell(MANIFEST, workload)
    entry = {c["name"]: c for c in MANIFEST["configs"]}[cell["config"]]
    assert config["name"] == cell["config"] and config["reduced"] == entry["reduced"]
    route = harness.route_module(traffic)
    for fn in ("setup", "window", "trace_count", "traced_request", "release", "check", "control"):
        assert callable(getattr(route, fn))
    assert traffic["limits"] and all(NAME.match(k) and v >= 0 for k, v in traffic["limits"].items())
    assert workload in TINY, f"benchmark/tests/tiny/{workload}.json holds the cell's sizes for CPU runs"
    reported = harness.cell_metrics(MANIFEST, workload, False)
    names = {m["name"] for m in reported}
    assert "setup_s" in names and len(names) >= 2
    assert harness.cell_metrics(MANIFEST, workload, True)


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_has_reader(metric):
    assert callable(harness.metric_reader(metric))


def test_manifest_keeps_the_contract():
    m = MANIFEST
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert m["paths"] == ["benchmark"] and m["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    # a full check with 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (m["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("benchmark/") and (BENCH.parent / c["file"]).is_file()
    cfg_names = {c["name"] for c in m["configs"]}
    assert cfg_names == {w["config"] for w in m["workloads"]}
    pairs = set()
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["chips"] == 1 and len(w["why"]) <= 200 and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert [e["name"] for e in m["end_to_end"] if e["name"] == "setup_s"] == ["setup_s"]
    for e in m["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= e["bound"] <= 0.25 and e["source"] in ("host_clock", "device_trace")
    for p in m["per_layer"]:
        assert set(p) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert p["moves"] in {e["name"] for e in m["end_to_end"]}
        for w in p.get("workloads", []):
            assert w in WORKLOADS
            assert p["moves"] in {x["name"] for x in harness.cell_metrics(m, w, False)}
    for x in METRICS:
        assert NAME.match(x["name"]) and UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
    assert len(json.dumps(m)) <= 64 * 1024


def test_subseed_takes_any_whole_number():
    for s in (0, 1, 2**31 + 17, 2**40, -5):
        a, b = harness.subseed(s, 1), harness.subseed(s, 1)
        assert a == b and 0 <= a < 2**63
    assert harness.subseed(2**31 + 17, 1) != harness.subseed(2**31 + 18, 1)
    assert harness.subseed(5, 1) != harness.subseed(-5, 1)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_result_line(workload):
    rc, res = run_tiny(workload)
    assert rc == 0 and res is not None
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert res["correct"] is True and res["attempted"] >= 1 and res["failed"] == 0
    want = {m["name"] for m in harness.cell_metrics(MANIFEST, workload, False)}
    assert set(res["metrics"]) == want
    for v in res["metrics"].values():
        assert set(v) == {"value", "unit"} and v["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])
    for v in res["checks"].values():
        assert set(v) == {"value", "limit"} and v["value"] <= v["limit"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_traced_result_line(workload, monkeypatch):
    """A traced run carries `breakdown` and the device's busy and window
    seconds. On the CPU no operation runs on a device, so the profiler's
    events are stood in for by device events laid under the window span."""
    def events(prof):
        real = [e for e in prof_events(prof) if not e[1]]
        win = [e for e in real if e[0] == "window"][0]
        s, e = win[2], win[3]
        step = (e - s) // 10
        return real + [("gram_tri_sm90_kernel<gbm_sm90::OpS8>", True, s + i * step, s + i * step + step // 2)
                       for i in range(10)]

    prof_events = harness.profiler_events
    monkeypatch.setattr(harness, "profiler_events", events)
    rc, res = run_tiny(workload, trace=1)
    assert rc == 0 and res is not None
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"]
    assert res["device"]["busy_s"] > 0 and res["device"]["window_s"] >= res["device"]["busy_s"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in res["breakdown"].values())
    assert res["metrics"] and set(res["metrics"]) <= {m["name"] for m in MANIFEST["per_layer"]}
    # the program's spans and counters reached the readers (no device times on the CPU)
    wants = {"gblup_refit": {"gblup_program_idle_ms", "k2_clustered_per_refit"}, "cv_sweep": {"cv_lasso_idle_pct"}}
    traffic = harness.resolve_cell(MANIFEST, workload)[2]
    assert wants[traffic["route"]] <= set(res["metrics"])


def test_reduce_trace_busy_gaps_and_clipping():
    ev = [("window", False, 100, 200), ("grm", False, 100, 150), ("solve", False, 150, 190),
          ("k", True, 90, 120), ("k", True, 130, 140), ("m", True, 160, 205), ("grm", True, 100, 150)]
    t = harness.reduce_trace(ev)
    assert t["window_s"] == pytest.approx(100e-9)
    assert t["busy_s"] == pytest.approx((20 + 10 + 40) * 1e-9)
    assert t["ops"]["k"][1] == 2 and t["ops"]["m"][0] == pytest.approx(40e-9)
    assert t["gaps"] == {"grm": pytest.approx(10e-9), "solve": pytest.approx(20e-9)}
    assert harness.kernel_seconds(t, "k") == (pytest.approx(30e-9), 2)
    assert harness.reduce_trace([("window", False, 0, 10)]) is None


def test_split_gaps_cut_at_program_spans():
    """The program's host spans cut the idle gaps where they open and close,
    while the reduction's busy time, operations and midpoint gaps stay as
    without them, and no `gbm.` event counts as a device operation."""
    base = [("window", False, 100, 200), ("grm", False, 100, 150), ("solve", False, 150, 190),
            ("k", True, 90, 120), ("k", True, 130, 140), ("m", True, 160, 205)]
    prog = [("gbm.grm", False, 102, 148), ("gbm.grm.kernel", False, 104, 130), ("gbm.solve", False, 152, 188),
            ("gbm.grm", True, 103, 149)]  # a device copy of the span's annotation
    old = harness.reduce_trace(base)
    assert harness.reduce_trace(base + prog) == old and "gbm.grm" not in old["ops"]
    assert harness.split_gaps(base) == {"grm": pytest.approx(20e-9), "solve": pytest.approx(10e-9)}
    # the gap 140-160 crosses gbm.grm (to 148), grm (to 150), solve (to 152) and gbm.solve
    assert harness.split_gaps(base + prog) == {
        "gbm.grm.kernel": pytest.approx(10e-9), "gbm.grm": pytest.approx(8e-9), "grm": pytest.approx(2e-9),
        "solve": pytest.approx(2e-9), "gbm.solve": pytest.approx(8e-9)}
    assert sum(harness.split_gaps(base + prog).values()) == pytest.approx(sum(old["gaps"].values()))
    assert harness.split_gaps([("k", True, 0, 5)]) == {}


def _span(count, device_s):
    return {"count": count, "host_s": 1.0, "self_host_s": 0.5, "device_s": device_s, "parent": None}


@pytest.mark.parametrize("program", [True, False])
def test_program_span_readers(program):
    """The readers of the program's spans and counters on a traced refit
    window and a traced CV window; none reads anything without them."""
    from types import SimpleNamespace

    refit = SimpleNamespace(
        traffic={"route": "gblup_refit", "panel": "bf16"}, config={}, traced_requests=4,
        trace={"window_s": 0.2, "split_gaps": {"gbm.grm": 1e-3, "gbm.solve.potrf": 5e-4, "issue": 2e-3}},
        program={"spans": {"gbm.grm": _span(4, 0.048), "gbm.grm.kernel": _span(4, 0.040),
                           "gbm.solve": _span(4, 0.044), "gbm.solve.potrf": _span(4, 0.036)},
                 "counters": {"gbm.grm.k2.clustered": 4}} if program else None)
    cv = SimpleNamespace(
        traffic={"route": "cv_sweep"}, config={"models": ["ridge", "gblup", "lasso"]}, traced_requests=2,
        trace={"window_s": 4.0, "split_gaps": {"gbm.cv.lasso.fista": 1.0, "gbm.cv.lasso_solve": 0.2,
                                               "gbm.cv.eigh": 0.1, "cv_call": 0.05}},
        program={"spans": {"gbm.cv.eigh": _span(4, 1.5)}, "counters": {}} if program else None)
    want_refit = {"grm_ms": 12.0, "solve_ms": 11.0, "grm_passes_ms": 2.0, "potrf_ms": 9.0,
                  "gblup_program_idle_ms": 0.375, "k2_clustered_per_refit": 1.0}
    want_cv = {"cv_eigh_s": 0.75, "cv_lasso_idle_pct": 30.0}
    for ctx, want in ((refit, want_refit), (cv, want_cv)):
        for name, value in want.items():
            got = harness.metric_reader(name)(ctx)
            assert got == (pytest.approx(value) if program else None), name
    for name in want_refit:  # each reads its own route's cells only
        assert harness.metric_reader(name)(cv) is None
    for name in want_cv:
        assert harness.metric_reader(name)(refit) is None


def test_no_result_without_a_card():
    """The command exits non-zero and prints nothing on standard output where
    torch sees no CUDA device (this host)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    r = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", WORKLOADS[0], "--seed", "1",
                        "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
                       cwd=BENCH.parent)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_no_result_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's folder
    the run fails: the program is not there."""
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, time; sys.path.insert(0, 'benchmark'); import run; "
            f"sys.exit(run.main(['--workload', {WORKLOADS[0]!r}, '--seed', '1', '--seconds', '0.1', "
            f"'--trace', '0'], require_chip=False, device='cpu', config_overrides={TINY[WORKLOADS[0]][0]!r}))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=tmp_path,
                       env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path), "PYTHONNOUSERSITE": "1"})
    assert r.returncode != 0 and "{" not in r.stdout
    assert "genomicbreedingmodels_tpu_torch" in r.stderr


def test_percentile_is_numpy_linear():
    assert harness.percentile([1, 2, 3, 4], 50) == 2.5
    assert math.isclose(harness.percentile(range(101), 95), 95.0)
