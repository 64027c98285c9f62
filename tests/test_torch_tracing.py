"""The program's spans and counters (utils/logging.py: `span`, `count`,
`tracing`, `reset`, `collect`, and `StageTimer`'s stages as spans) on the
CPU: off records nothing and touches neither the profiler nor CUDA events;
parents and self time across threads; counters, `gbm.solve.not_pd` among
them; every named span of the GRM, solve and batched-CV entry points in a
`torch.profiler` trace; and results bit-identical with tracing on and off."""

import threading
import time

import numpy as np
import pytest
import torch

import genomicbreedingmodels_tpu_torch as gt
from genomicbreedingmodels_tpu_torch.cv import batched
from genomicbreedingmodels_tpu_torch.ops.chol import gblup_solve_lower
from genomicbreedingmodels_tpu_torch.ops.grm import gram_dosage_lower, gram_panel
from genomicbreedingmodels_tpu_torch.utils import logging as tr

torch.set_num_threads(2)
CPU = "cpu"

GRM_INT8 = {"gbm.grm", "gbm.grm.kernel", "gbm.grm.epilogue", "gbm.grm.rowmeans", "gbm.grm.center"}
GRM_FREQ = {"gbm.grm", "gbm.grm.kernel", "gbm.grm.mirror", "gbm.grm.rowmeans", "gbm.grm.center"}
SOLVE = {"gbm.solve", "gbm.solve.mirror", "gbm.solve.potrf", "gbm.solve.potrs"}
CV_STAGES = {"h2d+gram", "ridge_solve", "ridge_emit", "gblup_solve", "gblup_emit", "lasso_grid",
             "lasso_solve", "lasso_emit"}
CV = ({"gbm.cv", "gbm.cv.eigh", "gbm.cv.path", "gbm.cv.readback", "gbm.cv.lasso.fold",
       "gbm.cv.lasso.power_iter", "gbm.cv.lasso.fista"} | {"gbm.cv." + s for s in CV_STAGES})


@pytest.fixture(autouse=True)
def _fresh():
    tr.reset()
    yield
    tr.reset()


def _dosages(n=40, p=300, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 3, (n, p)).astype(np.int8))


def _phenotype(n=40, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=n).astype(np.float32))


def _refit_int8():
    return gblup_solve_lower(gram_dosage_lower(_dosages(), device=CPU), _phenotype(), 30.0)


def _refit_freq():
    X = torch.from_numpy(np.random.default_rng(2).random((40, 300)).astype(np.float32))
    return gblup_solve_lower(torch.tril(gram_panel(X, device=CPU)), _phenotype(), 30.0)


@pytest.fixture(scope="module")
def cv_inputs():
    g = gt.simulate_genomes(n=48, l=240, seed=3)
    trials, _ = gt.simulate_trials(g, f_add_dom_epi=np.array([[0.4, 0.05, 0.05]]), seed=3)
    return g, gt.extract_phenomes(trials)


def _cv(cv_inputs):
    g, p = cv_inputs
    cvs, notes = batched.cvbulk_batched(g, p, models=("ridge", "gblup", "lasso"), n_replications=1,
                                        n_folds=3, seed=5, store_effects=True, device=CPU)
    return [(cv.fit.model, cv.replication, cv.fold, cv.fit.extras["lambda"], cv.y_pred, cv.fit.y_pred,
             cv.fit.b_hat, cv.metrics, cv.fit.metrics) for cv in cvs], notes


def test_tracing_off_records_nothing(monkeypatch, cv_inputs):
    """Off: `span` hands back one shared no-op object, and neither it, `count`
    nor the instrumented entry points open a profiler range or make a CUDA
    event; `collect` then finds nothing."""
    calls = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda *a, **k: calls.append(("range", a)))
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: calls.append(("event", a)))
    assert not tr.tracing_on()
    assert tr.span("gbm.a") is tr.span("gbm.b", device="cuda")
    with tr.span("gbm.a", device="cuda"):
        tr.count("gbm.n")
        tr.count("gbm.t", torch.ones(3, dtype=torch.bool))
    _refit_int8()
    _refit_freq()
    _cv(cv_inputs)
    assert calls == []
    got = tr.collect()
    assert got["spans"] == {} and got["counters"] == {}


def test_span_parents_and_self_time_across_threads():
    """Each thread's spans take their parent from that thread's own stack, and
    a span's self time is its duration less its children's."""
    barrier = threading.Barrier(2)

    def work(i):
        with tr.span(f"gbm.t{i}.outer"):
            barrier.wait(timeout=30)
            time.sleep(0.01)
            with tr.span(f"gbm.t{i}.inner"):
                barrier.wait(timeout=30)
                time.sleep(0.02)
            with tr.span("gbm.shared"):
                pass

    with tr.tracing():
        threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    spans = tr.collect()["spans"]
    for i in range(2):
        outer, inner = spans[f"gbm.t{i}.outer"], spans[f"gbm.t{i}.inner"]
        assert outer["parent"] is None and inner["parent"] == f"gbm.t{i}.outer"
        assert outer["count"] == inner["count"] == 1
        assert inner["self_host_s"] == pytest.approx(inner["host_s"], abs=1e-12)
        assert inner["host_s"] >= 0.02 and outer["self_host_s"] >= 0.01
        kids = inner["host_s"] + spans["gbm.shared"]["host_s"] / 2
        assert outer["self_host_s"] <= outer["host_s"] - inner["host_s"] + 1e-9
        assert outer["self_host_s"] >= outer["host_s"] - kids - 1e-3
        assert outer["device_s"] is None and inner["device_s"] is None
    assert spans["gbm.shared"]["count"] == 2
    assert sorted(spans["gbm.shared"]["parent"]) == ["gbm.t0.outer", "gbm.t1.outer"]


def test_counters_and_not_pd():
    """Host and tensor counters add up; `gbm.solve.not_pd` counts the solve of
    a matrix that is not positive definite (1) and not the one that is (0)."""
    with tr.tracing():
        tr.count("gbm.k")
        tr.count("gbm.k", 4)
        tr.count("gbm.flags", torch.tensor([True, False, True]))
        tr.count("gbm.flags", torch.tensor([True]))
    assert tr.collect()["counters"] == {"gbm.k": 5, "gbm.flags": 3}
    tr.reset()
    y = _phenotype(8)
    with tr.tracing():
        g = gblup_solve_lower(torch.eye(8), y, 1.0)
    assert torch.isfinite(g).all() and tr.collect()["counters"] == {"gbm.solve.not_pd": 0}
    tr.reset()
    with tr.tracing():
        g = gblup_solve_lower(-10.0 * torch.eye(8), y, 1.0)
    assert not torch.isfinite(g).all() and tr.collect()["counters"] == {"gbm.solve.not_pd": 1}


def test_reset_and_collect():
    """What two `tracing()` blocks record adds up until `reset()`; nothing is
    recorded between them; `launches` counts the kernels' launches since the
    window opened (none on the CPU, whose plain versions never count)."""
    with tr.tracing():
        with tr.span("gbm.x"):
            tr.count("gbm.n")
    with tr.span("gbm.x"):
        tr.count("gbm.n")
    with tr.tracing():
        with tr.span("gbm.x"):
            tr.count("gbm.n")
        _refit_int8()
    got = tr.collect()
    assert got["spans"]["gbm.x"]["count"] == 2 and got["counters"]["gbm.n"] == 2
    assert set(got["spans"]) == {"gbm.x"} | GRM_INT8 | SOLVE
    assert got["launches"] == {k: 0 for k in got["launches"]} and "gram_tri_int8" in got["launches"]
    assert tr.collect() == got  # collecting does not consume
    tr.reset()
    got = tr.collect()
    assert got["spans"] == {} and got["counters"] == {}


def _trace_names(fn):
    """(result, names of the profiler's host events, collect()) of one call
    of `fn` inside `tracing()` under `torch.profiler`."""
    from torch.profiler import ProfilerActivity, profile

    with tr.tracing(), profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, {e.name for e in prof.events()}, tr.collect()


@pytest.mark.parametrize("entry,want", [
    (_refit_int8, GRM_INT8 | SOLVE),
    (_refit_freq, GRM_FREQ | SOLVE),
])
def test_refit_spans_in_profiler_trace_and_bits_unchanged(entry, want):
    """Every named span of the Gram and the solve is a range of the profiler's
    trace and a span of `collect()`, each under its parent, and the GEBVs
    are the same bits as untraced."""
    plain = entry()
    traced, names, got = _trace_names(entry)
    assert torch.equal(plain, traced)
    assert want <= names
    assert {n for n in names if n.startswith("gbm.")} == set(got["spans"]) == want
    spans = got["spans"]
    assert spans["gbm.grm"]["parent"] is None and spans["gbm.solve"]["parent"] is None
    for name in want - {"gbm.grm", "gbm.solve"}:
        assert spans[name]["parent"] == name.rsplit(".", 1)[0], name
    assert spans["gbm.grm"]["count"] == spans["gbm.solve"]["count"] == 1
    if entry is _refit_freq:
        assert spans["gbm.grm.mirror"]["count"] == 2  # the kernel's triangle, then the centered matrix


def test_cv_spans_in_profiler_trace_and_records_unchanged(cv_inputs):
    """Every named span of `cvbulk_batched` is a range of the profiler's trace
    and a span of `collect()` under its parent; its records and notes are
    the same bits as untraced."""
    plain = _cv(cv_inputs)
    traced, names, got = _trace_names(lambda: _cv(cv_inputs))
    assert len(plain[0]) == len(traced[0]) == 9 and plain[1] == traced[1]
    for a, b in zip(plain[0], traced[0]):
        assert a[:4] == b[:4]
        for x, z in zip(a[4:7], b[4:7]):
            assert np.array_equal(x, z)
        assert a[7] == b[7] and a[8] == b[8]
    assert CV <= names
    assert {n for n in names if n.startswith("gbm.")} == set(got["spans"]) == CV
    spans = got["spans"]
    assert spans["gbm.cv"]["parent"] is None and spans["gbm.cv"]["count"] == 1
    for s in CV_STAGES:
        assert spans["gbm.cv." + s]["parent"] == "gbm.cv"
    assert sorted(spans["gbm.cv.eigh"]["parent"]) == ["gbm.cv.gblup_solve", "gbm.cv.ridge_solve"]
    assert spans["gbm.cv.lasso.fold"]["parent"] == "gbm.cv.lasso_solve"
    assert spans["gbm.cv.lasso.fold"]["count"] == 3
    assert spans["gbm.cv.lasso.fista"]["parent"] == "gbm.cv.lasso.fold"
    assert spans["gbm.cv.lasso.power_iter"]["parent"] == "gbm.cv.lasso.fold"
    assert spans["gbm.cv.readback"]["count"] == 3


def test_stage_timer_stages_are_spans(cv_inputs):
    """`LAST_TIMER` keeps its keys with tracing on, and each of its stages is
    the span `gbm.cv.<stage>` with the same count; a plain StageTimer's
    stages are `gbm.<stage>`."""
    _cv(cv_inputs)
    keys_off = set(batched.LAST_TIMER.summary())
    tr.reset()
    with tr.tracing():
        _cv(cv_inputs)
        timer = tr.StageTimer()
        with timer.stage("probe"):
            pass
    summary = batched.LAST_TIMER.summary()
    spans = tr.collect()["spans"]
    assert set(summary) == keys_off == CV_STAGES
    for k, v in summary.items():
        assert spans["gbm.cv." + k]["count"] == v["count"]
    assert spans["gbm.probe"]["count"] == 1 and timer.counts == {"probe": 1}


def _stage_spans_script():
    """scripts/torch_stage_spans.py as a module; the benchmark's folder it puts
    on `sys.path` (and its `harness`) are taken off again for the other tests."""
    import importlib.util
    import sys
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "scripts" / "torch_stage_spans.py"
    spec = importlib.util.spec_from_file_location("torch_stage_spans", path)
    mod = importlib.util.module_from_spec(spec)
    saved = list(sys.path)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
        sys.modules.pop("harness", None)
    return mod


def test_program_spans_name_gaps_and_keep_the_reduction():
    """With the program's host spans in a trace, `scripts/torch_stage_spans.py`
    names each idle gap by the innermost harness or program span, while the
    benchmark's reduction of the same trace keeps its busy time, window,
    device operations and the gaps' sum."""
    script = _stage_spans_script()
    harness = script.harness
    base = [("window", False, 100, 200), ("grm", False, 100, 150), ("solve", False, 150, 190),
            ("k", True, 90, 120), ("k", True, 130, 140), ("m", True, 160, 205)]
    prog = [("gbm.grm", False, 102, 148), ("gbm.grm.kernel", False, 104, 130), ("gbm.solve", False, 152, 188)]
    old = harness.reduce_trace(base)
    plain = harness.reduce_trace(base + prog)
    spans = harness.SPANS
    with script.program_spans(base + prog):
        new = harness.reduce_trace(base + prog)
    assert harness.SPANS == spans
    assert plain == old
    assert (new["busy_s"], new["window_s"], new["ops"]) == (old["busy_s"], old["window_s"], old["ops"])
    assert sum(new["gaps"].values()) == pytest.approx(sum(old["gaps"].values()), abs=1e-18)
    assert old["gaps"] == {"grm": pytest.approx(10e-9), "solve": pytest.approx(20e-9)}
    assert new["gaps"] == {"gbm.grm.kernel": pytest.approx(10e-9), "solve": pytest.approx(20e-9)}
    with script.program_spans(base + prog):
        split = script.split_gaps(base + prog, new)
    # the gap 140-160 crosses gbm.grm (to 148), grm (to 150), solve (to 152) and gbm.solve
    assert split == {"gbm.grm.kernel": pytest.approx(10e-9), "gbm.grm": pytest.approx(8e-9),
                     "grm": pytest.approx(2e-9), "solve": pytest.approx(2e-9), "gbm.solve": pytest.approx(8e-9)}


def test_stage_spans_script_runs_a_tiny_cell(tmp_path):
    """The script runs the int8 refit cell at a tiny size on the CPU: four
    windows (spans only in the two traced ones, every refit's spans once),
    the profiled window's spans, and the cell's check passing."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    ov = {"config": {"n_entries": 96, "n_loci": 1024},
          "traffic": {"n_causal": 16, "trace_refits": 5, "min_refit_s": 1e-4}}
    out = tmp_path / "spans.json"
    r = subprocess.run([sys.executable, "scripts/torch_stage_spans.py", "--workload", "gblup-refit-int8",
                        "--seed", "3000000019", "--seconds", "0.2", "--device", "cpu",
                        "--overrides", json.dumps(ov), "--out", str(out)],
                       capture_output=True, text=True, timeout=300, cwd=root)
    assert r.returncode == 0, r.stderr[-2000:]
    got = json.loads(out.read_text())
    assert got == json.loads(r.stdout.strip().splitlines()[-1]) and got["correct"]
    assert [w["tracing"] for w in got["windows"]] == [False, True, True, False]
    for w in got["windows"]:
        assert w["requests"] > 0 and w["rate"] > 0
        assert ("spans" in w) == w["tracing"]
        if w["tracing"]:
            assert set(w["spans"]) == GRM_INT8 | SOLVE
            assert all(s["count"] == 1 and s["device_ms"] is None for s in w["spans"].values())
            assert w["counters"] == {"gbm.solve.not_pd": 0}
    assert set(got["profiled"]["spans"]) == GRM_INT8 | SOLVE
    assert got["profiled"]["spans"]["gbm.grm"]["count"] == 1


def test_kernels_by_span_owner_and_launch_lag():
    """Each kernel goes to the innermost program span whose device annotation
    holds it; a span's lag runs from its host start to its annotation's."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    def ev(name, dev, s, e, ann=False):
        return SimpleNamespace(name=lambda: name, start_ns=lambda: s, duration_ns=lambda: e - s,
                               device_type=lambda: DeviceType.CUDA if dev else DeviceType.CPU,
                               is_user_annotation=lambda: ann)

    events = [ev("gbm.solve", False, 100, 300), ev("gbm.solve.potrf", False, 110, 200),
              ev("gbm.solve", True, 120, 400, True), ev("gbm.solve.potrf", True, 130, 350, True),
              ev("getrf", True, 130, 300), ev("syrk", True, 300, 340), ev("trsv", True, 360, 390),
              ev("late", True, 900, 950)]
    prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: events)))
    owners, lags = _stage_spans_script().kernels_by_span(prof, 0, 800)
    assert owners == {"gbm.solve.potrf": {"getrf": pytest.approx(170e-9), "syrk": pytest.approx(40e-9)},
                      "gbm.solve": {"trsv": pytest.approx(30e-9)}}
    assert lags == {"gbm.solve": [pytest.approx(20e-6)] * 3, "gbm.solve.potrf": [pytest.approx(20e-6)] * 3}
