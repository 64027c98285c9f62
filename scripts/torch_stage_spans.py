#!/usr/bin/env python3
"""The program's own spans (utils/logging.py) read in a benchmark cell, on a card.

    python3 scripts/torch_stage_spans.py --workload gblup-refit-int8 --seed 7 --seconds 20 \
        [--out spans.json]

from the root of a checkout. It sets up the cell as `benchmark/run.py` does
(the same configuration, traffic file, route and seed), then runs four
measured windows of `--seconds` each, with the program's tracing off, on,
on, off (the rate with spans on against off, in turns on one card), then one
short window under `torch.profiler` with tracing on, then the cell's check
of the answers. It prints one JSON object:

- `windows`: each window's requests and rate; the two traced ones also
  every span's count, host, self-host and device milliseconds per request
  and its parent, the counters, the kernel launches, and `readings`:
  `grm_passes_ms` (a refit's `gbm.grm` device time less `gbm.grm.kernel`'s),
  `potrf_ms` (`gbm.solve.potrf`'s), `gbm.grm` and `gbm.solve` against the
  harness's CUDA-event `grm_ms` and `solve_ms` of the same window, and
  `cv_eigh_s` (a call's `gbm.cv.eigh`);
- `profiled`: the profiled window's idle gaps named as the benchmark names
  them (`idle_gaps_harness`) and by the innermost of the harness's and the
  program's spans (`idle_gaps_program`), whether busy time, window and
  device operations read the same both ways and the two sums of the gaps,
  `program_idle_ms` (idle under a `gbm.` span, per request), the same
  apportioned over time (`idle_split`, `program_idle_ms_split`: a gap
  that crosses spans is cut where they open and close),
  `cv_lasso_idle_pct` (idle under `gbm.cv.lasso_solve` or a `gbm.cv.lasso.*`
  span, share of the window), the Gram kernel's device ms a launch,
  `kernels_by_span` (each kernel's device seconds per request by the
  innermost program span the profiler's device annotations put it in),
  `launch_lag_ms` (a span's host start to its first kernel's start: a
  negative one shows the trace's host and device clocks apart, which would
  misname gaps) and the spans per request;
- `checks` and `correct`: the cell's comparison with its reference, on the
  answers of the last window.

`--device cpu --overrides '{"config": {...}, "traffic": {...}}'` runs it on
the host at a small size (no device times). Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from contextlib import contextmanager, nullcontext
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "benchmark"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import harness  # noqa: E402


@contextmanager
def program_spans(events):
    """Name idle gaps by the program's `gbm.` spans as well as the harness's:
    `harness.reduce_trace` takes the innermost span of `harness.SPANS`, so
    the program's span names found in `events` join that tuple for the
    block. Its busy time, window and device operations do not read `SPANS`
    for host events, and the profiler's device copies of the spans are left
    out before (`harness.profiler_events`)."""
    names = sorted({n for n, dev, _, _ in events if not dev and n.startswith("gbm.")})
    saved = harness.SPANS
    harness.SPANS = saved + tuple(names)
    try:
        yield
    finally:
        harness.SPANS = saved


def split_gaps(events, trace: dict) -> dict:
    """The idle seconds of a reduced trace apportioned over time: each idle
    interval is cut where a harness or program span opens or closes, and each
    piece goes to the innermost span the host was in ("harness" in none).
    `harness.reduce_trace` names a whole gap by the span at its middle, which
    hands a gap that crosses from the client's code into the program's to
    one of them."""
    spans = sorted((s, e, n) for n, dev, s, e in events
                   if not dev and (n in harness.SPANS or n.startswith("gbm.")))
    w0, w1 = min((s, e) for n, dev, s, e in events if not dev and n == "window")
    busy = harness._union([(max(s, w0), min(e, w1)) for n, dev, s, e in events
                           if dev and n not in harness.SPANS and n != "window" and e > w0 and s < w1])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    out: dict[str, float] = {}
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        near = [(s, e, n) for s, e, n in spans if s < g1 and e > g0]
        cuts = sorted({g0, g1} | {x for s, e, _ in near for x in (s, e) if g0 < x < g1})
        for a, b in zip(cuts, cuts[1:]):
            mid = (a + b) / 2
            inner = [(s, n) for s, e, n in near if s <= mid < e]
            name = max(inner)[1] if inner else "harness"
            out[name] = out.get(name, 0.0) + (b - a) * 1e-9
    return out


def kernels_by_span(prof, w0: int, w1: int) -> tuple[dict, dict]:
    """Device seconds of each kernel inside [w0, w1], by the innermost
    program span whose device annotation holds its middle ("none" outside
    every one); and, for each span whose host ranges and device annotations
    pair up one to one in the window, the least, median and largest
    milliseconds from a host range's start to its device annotation's (the
    first kernel it launched): a negative lag would be a skew between the
    trace's host and device clocks."""
    import statistics

    from torch.autograd import DeviceType

    spans, kernels, starts = [], [], {}
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        t = s + e.duration_ns()
        name = e.name()
        if name.startswith("gbm.") and w0 <= s < w1:
            starts.setdefault(name, ([], []))[e.device_type() != DeviceType.CPU].append(s)
        if e.device_type() == DeviceType.CPU:
            continue
        if e.is_user_annotation():
            if name.startswith("gbm."):
                spans.append((s, t, name))
        elif w0 <= s and t <= w1:
            kernels.append((name, s, t))
    spans.sort()
    out: dict[str, dict[str, float]] = {}
    for name, s, t in kernels:
        mid = (s + t) // 2
        inner = [(a, n) for a, b, n in spans if a <= mid < b]
        owner = max(inner)[1] if inner else "none"
        k = out.setdefault(owner, {})
        k[name[:90]] = k.get(name[:90], 0.0) + (t - s) * 1e-9
    lags = {}
    for name, (host, dev) in starts.items():
        if host and len(host) == len(dev):
            d = [(b - a) * 1e-6 for a, b in zip(sorted(host), sorted(dev))]
            lags[name] = [min(d), statistics.median(d), max(d)]
    return out, lags


def per_request(program: dict, requests: int) -> dict:
    """Every span's count and milliseconds per request."""
    out = {}
    for name, s in sorted(program["spans"].items()):
        out[name] = {"count": s["count"] / requests, "host_ms": 1e3 * s["host_s"] / requests,
                     "self_host_ms": 1e3 * s["self_host_s"] / requests,
                     "device_ms": None if s["device_s"] is None else 1e3 * s["device_s"] / requests,
                     "parent": s["parent"]}
    return out


def readings(program: dict, requests: int, stage_ms: dict) -> dict:
    """The per-layer numbers of one traced window."""
    sp = program["spans"]

    def dev_ms(name):
        s = sp.get(name)
        return None if s is None or s["device_s"] is None else 1e3 * s["device_s"] / s["count"]

    out = {}
    if "gbm.grm" in sp:
        grm, kernel, solve = dev_ms("gbm.grm"), dev_ms("gbm.grm.kernel"), dev_ms("gbm.solve")
        out["grm_passes_ms"] = None if grm is None else grm - kernel
        out["potrf_ms"] = dev_ms("gbm.solve.potrf")
        out["gbm.grm_ms"], out["gbm.solve_ms"] = grm, solve
        if stage_ms:
            out["grm_ms"], out["solve_ms"] = stage_ms["grm"], stage_ms["solve"]
            out["gbm.grm_over_grm_ms"] = None if grm is None else grm / stage_ms["grm"]
            out["gbm.solve_over_solve_ms"] = None if solve is None else solve / stage_ms["solve"]
    if "gbm.cv.eigh" in sp and sp["gbm.cv.eigh"]["device_s"] is not None:
        out["cv_eigh_s"] = sp["gbm.cv.eigh"]["device_s"] / requests
    return out


def traced(ctx, route, cuda: bool):
    """The route's traced requests under `torch.profiler` with the program's
    tracing on, as `benchmark/run.py` runs its traced window (its first
    request outside the window): (profiler, events, requests in the window)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from genomicbreedingmodels_tpu_torch.utils import logging as tr

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    n = route.trace_count(ctx)
    with tr.tracing(), profile(activities=acts) as prof:
        ctx.tracing = True
        try:
            route.traced_request(ctx, 0)
            tr.reset()  # the program's spans of the window's requests alone
            with record_function("window"):
                for j in range(1, n):
                    route.traced_request(ctx, j)
        finally:
            ctx.tracing = False
    return prof, harness.profiler_events(prof), n - 1


def idle(prof, events, requests: int) -> dict:
    old = harness.reduce_trace(events)
    with program_spans(events):
        new = harness.reduce_trace(events)
    if old is None:
        return {}
    gaps_new, window = new["gaps"], new["window_s"]
    lasso = sum(v for k, v in gaps_new.items() if k == "gbm.cv.lasso_solve" or k.startswith("gbm.cv.lasso."))
    idle_s = sum(gaps_new.values())
    w0, w1 = min((s, e) for n, dev, s, e in events if not dev and n == "window")
    k1, n1 = harness.kernel_seconds(new, "gram_tri_sm90_kernel")
    owners, lags = kernels_by_span(prof, w0, w1)
    split = split_gaps(events, new)
    return {
        "same_busy_window_ops": (old["busy_s"], old["window_s"], old["ops"]) == (new["busy_s"], new["window_s"],
                                                                              new["ops"]),
        "gaps_sum": [sum(old["gaps"].values()), idle_s],
        "idle_pct": 100.0 * idle_s / window,
        "idle_gaps_harness": sorted(old["gaps"].items(), key=lambda t: -t[1]),
        "idle_gaps_program": sorted(gaps_new.items(), key=lambda t: -t[1]),
        "program_idle_ms": 1e3 * sum(v for k, v in gaps_new.items() if k.startswith("gbm.")) / requests,
        "idle_split": sorted(split.items(), key=lambda t: -t[1]),
        "program_idle_ms_split": 1e3 * sum(v for k, v in split.items() if k.startswith("gbm.")) / requests,
        "cv_lasso_idle_pct": 100.0 * lasso / window,
        "outside_program_share": (gaps_new.get("cv_call", 0.0) + gaps_new.get("harness", 0.0)) / idle_s
        if idle_s else None,
        "gram_kernel_ms": 1e3 * k1 / n1 if n1 else None,
        "kernels_by_span": {o: {k: v / requests for k, v in sorted(ks.items(), key=lambda t: -t[1])[:8]}
                            for o, ks in owners.items()},
        "launch_lag_ms": lags,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--overrides", default="{}")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    harness.cache_env()
    cell, config, traffic = harness.resolve_cell(harness.load_manifest(), args.workload)
    ov = json.loads(args.overrides)
    config.update(ov.get("config", {}))
    traffic.update(ov.get("traffic", {}))

    import torch

    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        harness.note("# no CUDA device: no result")
        return 2
    dev = torch.device("cuda", 0) if cuda else torch.device(args.device)
    from genomicbreedingmodels_tpu_torch.kernels import _build
    from genomicbreedingmodels_tpu_torch.utils import logging as tr

    route = harness.route_module(traffic)
    ctx = harness.Ctx(cell, config, traffic, args.seed, args.seconds, True, dev, t0)
    if cuda:
        torch.cuda.set_device(dev)
        _build.load()
    route.setup(ctx)
    card = torch.cuda.get_device_name(dev) if cuda else "cpu"
    harness.note(f"# {args.workload} seed {args.seed} on {card}; set-up {time.perf_counter() - t0:.3f} s")
    windows = []
    for on in (False, True, True, False):
        tr.reset()
        before = dict(_build.LAUNCHES)
        with tr.tracing() if on else nullcontext():
            route.window(ctx)
        ctx.launches = {k: _build.LAUNCHES[k] - before[k] for k in before}
        w = {"tracing": on, "requests": ctx.window["requests"], "seconds": ctx.window["seconds"],
             "rate": ctx.window["work"] / ctx.window["seconds"]}
        stage_ms = {k: sum(v) / len(v) for k, v in ctx.stage_ms.items() if v}
        if on:
            program = tr.collect()
            w["spans"] = per_request(program, w["requests"])
            w["counters"], w["launches"] = program["counters"], program["launches"]
            w["readings"] = readings(program, w["requests"], stage_ms)
        harness.note(f"# window tracing={'on' if on else 'off'}: {w['requests']} requests, rate {w['rate']!r}")
        windows.append(w)
    tr.reset()
    prof, events, n = traced(ctx, route, cuda)
    profiled = idle(prof, events, n)
    profiled["spans"] = per_request(tr.collect(), n)
    tr.reset()
    route.release(ctx)
    checks = route.check(ctx)
    result = {"workload": args.workload, "seed": args.seed, "device": card, "windows": windows,
              "profiled": profiled, "checks": {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()},
              "correct": all(v <= lim for v, lim in checks.values())}
    text = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
