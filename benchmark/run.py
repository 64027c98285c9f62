#!/usr/bin/env python3
"""The benchmark of `genomicbreedingmodels_tpu_torch` on NVIDIA cards.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The workload is an entry of `BENCHMARK.json`'s
`workloads`; its configuration file, its traffic file (`traffic/<name>.json`,
whose `route` names the request loop in `routes/`) and its metrics'
readers (`metrics/<name>.py`) are found by name.

A run: set-up (inputs made on the device from the seed, the route's own
shapes warmed up), then a window of `--seconds` of requests, then, with
`--trace 1`, a short window of the same requests under `torch.profiler`
with the program's own spans and counters recorded (`utils/logging.py`;
its first request, which pays the profiler's start, outside the window),
then the check of the window's answers against the plain reference in
`reference/`. Standard error gets the card's clocks and power before and
after the window, the kernel launches of the window, and, last, every
number compared beside its limit. The last line of standard output is one
JSON object: `correct`, `attempted`, `failed`, `metrics` (the end-to-end
metrics, or with `--trace 1` the per-layer ones), `device`, with
`--trace 1` `breakdown`, and `checks`.

Exits 2 without a CUDA device (or with fewer than the cell asks for), and
3 if a module of JAX or of the JAX package is loaded once the window has
closed; neither prints a result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from contextlib import nullcontext  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))
if str(BENCH.parent) not in sys.path:
    sys.path.insert(1, str(BENCH.parent))

import harness  # noqa: E402


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, *, require_chip: bool = True, device: str = "cuda", config_overrides=None,
         traffic_overrides=None, t0: float | None = None) -> int:
    """One run. The tests pass `require_chip=False` and `device="cpu"` with
    small sizes in the overrides; the command line never does."""
    args = parse(argv)
    harness.cache_env()
    manifest = harness.load_manifest()
    cell, config, traffic = harness.resolve_cell(manifest, args.workload)
    config.update(config_overrides or {})
    traffic.update(traffic_overrides or {})

    import torch

    marks = [("python and torch", time.perf_counter())]
    if require_chip:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            harness.note(f"# {args.workload} needs {cell['chips']} CUDA device(s); this process sees "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result")
            return 2
        device = "cuda"
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    cuda = dev.type == "cuda"

    from genomicbreedingmodels_tpu_torch.kernels import _build

    route = harness.route_module(traffic)
    ctx = harness.Ctx(cell, config, traffic, args.seed, args.seconds, bool(args.trace), dev,
                      T0 if t0 is None else t0, marks)
    marks.append(("the program's modules", time.perf_counter()))
    if cuda:
        torch.cuda.set_device(dev)
        torch.cuda.init()
        marks.append(("the CUDA context", time.perf_counter()))
        _build.load()  # the kernels' library: built once per checkout, loaded from build/ after
        marks.append(("the kernels' library", time.perf_counter()))
    smi = harness.smi_start() if cuda else None
    try:
        route.setup(ctx)
    finally:
        card_before = harness.smi_read(smi) if smi is not None else None
    if cuda:
        harness.note(f"# card before the window: {card_before}")
        torch.cuda.reset_peak_memory_stats(dev)
    before = dict(_build.LAUNCHES)
    route.window(ctx)
    ctx.launches = {k: _build.LAUNCHES[k] - before[k] for k in before}
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        harness.note(f"# card after the window: {harness.smi_read(harness.smi_start())}")
    t_prev = ctx.t0
    steps = []
    for name, t in marks:
        steps.append(f"{name} {t - t_prev:.3f} s")
        t_prev = t
    harness.note("# set-up: " + "; ".join(steps) + f"; to the first request {ctx.t0 + ctx.setup_s - t_prev:.3f} s")
    harness.note(f"# {args.workload}: {ctx.window['requests']} requests in {ctx.window['seconds']:.6f} s; "
                 f"set-up {ctx.setup_s:.6f} s; launches in the window "
                 + " ".join(f"{k}={v}" for k, v in ctx.launches.items()))

    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": cell["chips"], "memory_peak_bytes": int(peak)}
    if ctx.traced:
        ctx.trace = traced_window(ctx, route, cuda)
        device_info["busy_s"] = ctx.trace["busy_s"] if ctx.trace else None
        device_info["window_s"] = ctx.trace["window_s"] if ctx.trace else None

    route.release(ctx)
    if cuda:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    checks = route.check(ctx)
    harness.note(f"# check took {time.perf_counter() - t_check:.3f} s")
    correct = all(v <= lim for v, lim in checks.values())

    metrics = {}
    for m in harness.cell_metrics(manifest, args.workload, ctx.traced):
        value = harness.metric_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": ctx.window["requests"], "failed": ctx.failed,
              "metrics": metrics, "device": device_info}
    if ctx.trace:
        result["breakdown"] = harness.breakdown(ctx.trace)
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    forbidden = harness.forbidden_loaded()
    if forbidden:
        harness.note(f"# FAILED: modules of JAX or of the JAX package are loaded: {forbidden}; no result")
        return 3
    for k, (v, lim) in checks.items():
        harness.note(f"check {k} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}")
    print(json.dumps(result), flush=True)
    return 0


def program_tracing():
    """The program's `utils/logging` module where it has `tracing`, `reset`
    and `collect`; None otherwise (a traced run then reads no program span)."""
    try:
        from genomicbreedingmodels_tpu_torch.utils import logging as tr
    except ImportError:
        return None
    return tr if all(hasattr(tr, f) for f in ("tracing", "reset", "collect")) else None


def traced_window(ctx, route, cuda: bool):
    """The route's traced requests under `torch.profiler` (the device's
    kernels, the harness's spans and the program's) with the program's
    tracing on, reduced to busy time, operations and idle gaps; the
    program's spans and counters of the window's requests go to
    `ctx.program`. Runs after the measured window: a process that has traced
    the card runs host-bound work slower afterwards."""
    from torch.profiler import ProfilerActivity, profile, record_function

    tr = program_tracing()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    n = route.trace_count(ctx)
    with tr.tracing() if tr else nullcontext(), profile(activities=acts) as prof:
        ctx.tracing = True
        try:
            route.traced_request(ctx, 0)  # the profiler's own start-up falls here, outside the window
            if tr:
                tr.reset()  # the program's spans and counters of the window's requests alone
            with record_function("window"):
                for j in range(1, n):
                    route.traced_request(ctx, j)
        finally:
            ctx.tracing = False
    ctx.traced_requests = n - 1
    if tr:
        ctx.program = tr.collect()
        tr.reset()
    t = time.perf_counter()
    events = harness.profiler_events(prof)
    trace = harness.reduce_trace(events)
    if trace is not None:
        trace["split_gaps"] = harness.split_gaps(events)
    harness.note(f"# traced {n - 1} requests; reduced the trace in {time.perf_counter() - t:.3f} s")
    return trace


if __name__ == "__main__":
    sys.exit(main())
