"""What every cell of the benchmark shares: seeds, cache directories, the
card's clocks before and after the window, the harness's spans, the reduction of a profiler trace, the
metric readers, the plain references found by the models they hold, and the result line.

Nothing here imports the program; `torch` is imported inside the functions
that need it, so the tests can load this module cheaply.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from contextlib import contextmanager
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
MANIFEST = ROOT / "BENCHMARK.json"

# Top-level module names that may not be loaded in a run: the JAX stack and
# the JAX package the port was made from. Compared whole: the port's own
# name starts with the JAX package's.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "genomicbreedingmodels_tpu")

# The harness's own spans. A device idle gap is named by the innermost one
# that the host was in at the gap's middle, "harness" where it was in none.
SPANS = ("inputs", "issue", "grm", "solve", "readback", "cv_call")

# The program names each of its spans (utils/logging.py) with this prefix.
# Its host ranges are spans for `split_gaps`; its events are never device work.
PROGRAM_SPAN = "gbm."

SMI_FIELDS = "index,name,clocks.sm,clocks.mem,power.draw,power.limit,temperature.gpu"


def cache_env() -> None:
    """Point every build and kernel cache at fixed directories inside the
    checkout, so that only a checkout's first run builds or compiles. The
    port's nvcc build already lives in `build/gbm_torch_kernels/` there."""
    base = ROOT / "build" / "benchmark_cache"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(base / "cuda")
    os.environ.setdefault("USE_FLAX", "0")


def subseed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one stream of the run, drawn from `--seed` and the
    stream's tags. Any whole number, negative or past 2**32, is a valid seed."""
    import numpy as np

    entropy = [abs(int(seed)) % 2**64, 1 if seed < 0 else 0, *tags]
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0] >> np.uint64(1))


def load_manifest(path: Path = MANIFEST) -> dict:
    return json.loads(path.read_text())


def resolve_cell(manifest: dict, workload: str) -> tuple[dict, dict, dict]:
    """(the workload entry, its configuration's file, its traffic file), found
    by the names in `BENCHMARK.json`."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = json.loads((ROOT / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell, config, traffic


def load_file_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def route_module(traffic: dict):
    return load_file_module(BENCH / "routes" / f"{traffic['route']}.py", f"bench_route_{traffic['route']}")


def references(models) -> dict:
    """{model: module} of the plain references under `reference/` that hold
    the models: each such module names them in `MODELS`. A model no module
    names is left out; two modules naming one model is an error."""
    import importlib
    import pkgutil

    import reference

    found: dict = {}
    for info in sorted(pkgutil.iter_modules(reference.__path__), key=lambda i: i.name):
        mod = importlib.import_module(f"reference.{info.name}")
        for m in getattr(mod, "MODELS", ()):
            if m in found:
                raise ValueError(f"model {m!r} is held by both {found[m].__name__} and {mod.__name__}")
            found[m] = mod
    return {m: found[m] for m in models if m in found}


def metric_reader(name: str):
    """`read(ctx)` of `metrics/<name>.py`: the metric's value, or None where
    the run gave it nothing to read."""
    return load_file_module(BENCH / "metrics" / f"{name}.py", "bench_metric_" + name.replace(".", "_")).read


def cell_metrics(manifest: dict, workload: str, traced: bool) -> list[dict]:
    """The metrics a run of `workload` reports: the end-to-end ones untraced,
    the per-layer ones traced, each where its `workloads` key lists the cell
    (or, without the key, where the cell reports the metric it moves)."""
    e2e = [m for m in manifest["end_to_end"] if workload in m.get("workloads", [workload])]
    if not traced:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def forbidden_loaded() -> list[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN_MODULES)


def smi_start():
    """Start one read-only `nvidia-smi` query of the card's clocks, power and
    temperature in the background; `smi_read` collects it."""
    try:
        return subprocess.Popen(["nvidia-smi", f"--query-gpu={SMI_FIELDS}", "--format=csv,noheader"],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    except OSError as err:
        return err


def smi_read(proc) -> str:
    if isinstance(proc, OSError):
        return f"nvidia-smi not run: {proc}"
    try:
        out, err = proc.communicate(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        return "nvidia-smi timed out"
    return " | ".join(out.strip().splitlines()) or f"nvidia-smi printed nothing ({err.strip()})"


def note(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Ctx:
    """One run: what the route set up and recorded, and what the metric
    readers read. The route adds its own attributes (`state`, `window`,
    `setup_s`, ...)."""

    def __init__(self, cell, config, traffic, seed, seconds, traced, device, t0, marks=None):
        import torch

        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.seconds, self.traced, self.device, self.t0 = seed, seconds, traced, device, t0
        self.marks = [] if marks is None else marks  # (set-up step, its end on the host clock)
        self.tracing = False  # inside the profiled window: spans are recorded
        self.failed = 0
        self.trace = None  # reduced device trace of a traced run
        self.program = None  # the program's spans and counters of the traced window (utils/logging.collect)
        self.traced_requests = 0  # the requests inside the traced window
        self.stage_ms: dict[str, list[float]] = {}  # stage times a caller records (scripts/torch_stage_spans.py)
        self.sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)

    @contextmanager
    def span(self, name: str):
        """A harness span: a `record_function` range while the profiler runs."""
        if not self.tracing:
            yield
            return
        from torch.profiler import record_function

        with record_function(name):
            yield


# --------------------------------------------------------------------------
# the device trace
# --------------------------------------------------------------------------


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _window(events, window: str) -> tuple[int, int] | None:
    wins = [(s, e) for name, dev, s, e in events if not dev and name == window]
    return (min(s for s, _ in wins), max(e for _, e in wins)) if wins else None


def _device_ops(events, w0: int, w1: int, window: str) -> list[tuple[str, int, int]]:
    """The device operations of the window, clipped to it: never a span of
    the harness or of the program."""
    return [(n, max(s, w0), min(e, w1)) for n, dev, s, e in events
            if dev and n not in SPANS and n != window and not n.startswith(PROGRAM_SPAN) and e > w0 and s < w1]


def _idle(busy: list[tuple[int, int]], w0: int, w1: int):
    """The idle intervals of the window between its busy ones."""
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    return [(g0, g1) for g0, g1 in zip(edges[0::2], edges[1::2]) if g1 > g0]


def reduce_trace(events: list[tuple[str, bool, int, int]], window: str = "window") -> dict | None:
    """Reduce profiler events (name, on the device, start ns, end ns) to the
    traced window's busy seconds, its length, each device operation's total
    seconds and count, and the idle gaps' seconds by the harness span the
    host was in. Device events outside the window are clipped to it.
    Returns None when the window span is missing or no device event ran."""
    win = _window(events, window)
    if win is None:
        return None
    w0, w1 = win
    dev_ev = _device_ops(events, w0, w1, window)
    if not dev_ev:
        return None
    ops: dict[str, list] = {}
    for n, s, e in dev_ev:
        o = ops.setdefault(n, [0.0, 0])
        o[0] += (e - s) * 1e-9
        o[1] += 1
    busy = _union([(s, e) for _, s, e in dev_ev])
    spans = sorted((s, e, n) for n, dev, s, e in events if not dev and n in SPANS)
    gaps: dict[str, float] = {}
    for g0, g1 in _idle(busy, w0, w1):
        mid = (g0 + g1) // 2
        inner = [(s, n) for s, e, n in spans if s <= mid < e]
        name = max(inner)[1] if inner else "harness"
        gaps[name] = gaps.get(name, 0.0) + (g1 - g0) * 1e-9
    return {
        "busy_s": sum(e - s for s, e in busy) * 1e-9,
        "window_s": (w1 - w0) * 1e-9,
        "ops": ops,
        "gaps": gaps,
    }


def split_gaps(events: list[tuple[str, bool, int, int]], window: str = "window") -> dict[str, float]:
    """The idle seconds of the traced window apportioned over time: each idle
    interval is cut where a span of the harness or of the program opens or
    closes, and each piece goes to the innermost span the host was in
    ("harness" in none). `reduce_trace` names a whole gap by the span at its
    middle, which hands a gap that crosses from the client's code into the
    program's to one of them."""
    win = _window(events, window)
    if win is None:
        return {}
    w0, w1 = win
    busy = _union([(s, e) for _, s, e in _device_ops(events, w0, w1, window)])
    spans = sorted((s, e, n) for n, dev, s, e in events
                   if not dev and (n in SPANS or n.startswith(PROGRAM_SPAN)))
    out: dict[str, float] = {}
    for g0, g1 in _idle(busy, w0, w1):
        near = [(s, e, n) for s, e, n in spans if s < g1 and e > g0]
        cuts = sorted({g0, g1} | {x for s, e, _ in near for x in (s, e) if g0 < x < g1})
        for a, b in zip(cuts, cuts[1:]):
            mid = (a + b) / 2
            inner = [(s, n) for s, e, n in near if s <= mid < e]
            name = max(inner)[1] if inner else "harness"
            out[name] = out.get(name, 0.0) + (b - a) * 1e-9
    return out


def profiler_events(prof) -> list[tuple[str, bool, int, int]]:
    """(name, on the device, start ns, end ns) of every event a
    `torch.profiler.profile` recorded. The device's own copies of the
    harness's user annotations are left out: they are not device work."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type() != DeviceType.CPU
        if dev and e.is_user_annotation():
            continue
        start = e.start_ns()
        out.append((e.name(), dev, start, start + e.duration_ns()))
    return out


def breakdown(trace: dict) -> dict:
    """The ten device operations with the most time and the ten longest idle
    gaps by span, seconds as measured."""
    ops = sorted(((n, v[0]) for n, v in trace["ops"].items()), key=lambda t: -t[1])[:10]
    gaps = sorted(trace["gaps"].items(), key=lambda t: -t[1])[:10]
    return {"device_ops": [[n[:120], s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}


def kernel_seconds(trace: dict | None, *needles: str) -> tuple[float, int]:
    """Total device seconds and count of the operations whose name holds
    every needle."""
    if trace is None:
        return 0.0, 0
    t, c = 0.0, 0
    for name, (s, k) in trace["ops"].items():
        if all(x in name for x in needles):
            t += s
            c += k
    return t, c


def program_span_ms(ctx, name: str) -> float | None:
    """Mean device milliseconds of the program's span `name` in the traced
    window, or None where the window recorded none on a device."""
    s = (ctx.program or {}).get("spans", {}).get(name)
    if s is None or s["device_s"] is None or not s["count"]:
        return None
    return 1e3 * s["device_s"] / s["count"]


def idle_under(ctx, *prefixes: str) -> float | None:
    """Idle seconds of the traced window cut to the spans whose names start
    with one of `prefixes` (`split_gaps`), or None where the program's spans
    were not recorded."""
    if ctx.program is None or not ctx.trace:
        return None
    return sum(v for k, v in ctx.trace["split_gaps"].items() if k.startswith(prefixes))


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between the closest ranks (numpy's default)."""
    import numpy as np

    return float(np.percentile(np.asarray(values, dtype=np.float64), q))
