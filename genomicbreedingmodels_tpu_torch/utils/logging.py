"""Structured logging, stage timing and the program's spans and counters.

`get_logger` and `StageTimer` are copied from
genomicbreedingmodels_tpu/utils/logging.py, with `torch_profile` in place
of `jax_profile`. `StageTimer` takes a lock around each update: the CV
executor's worker threads time their jobs into one timer.

Spans and counters (`span`, `count`) record only inside a `tracing()`
block; outside one, each costs the test of one module-level flag and
records nothing. A span recorded:

- a `torch.profiler.record_function` range, so that it lands in a profiler
  trace on the clock of the device's events;
- its host start and end (`time.perf_counter_ns`);
- its parent, from a per-thread stack of open spans;
- where it runs on a CUDA device (given, or its parent's), a pair of timing
  events on that device's current stream.

Nothing is read back while spans record: `collect()` synchronises once and
resolves the events then. Every span name of the program starts with
`gbm.`, which tells its spans from a caller's in one trace.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterator

__all__ = ["StageTimer", "collect", "count", "get_logger", "reset", "span", "torch_profile", "tracing",
           "tracing_on"]

_LOGGER = logging.getLogger("gbm_tpu")


def get_logger() -> logging.Logger:
    if not _LOGGER.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
        _LOGGER.addHandler(h)
        _LOGGER.setLevel(logging.INFO)
    return _LOGGER


# --------------------------------------------------------------------------
# spans and counters
# --------------------------------------------------------------------------

_TRACING = False  # the one flag that `span` and `count` test
_LOCK = threading.Lock()  # guards the three below: spans close and count from any thread
_RECORDS: list = []  # (name, parent name, host ns, self host ns, (start, end) events or None, device)
_COUNTS: dict = {}  # name -> int, or a tensor on the device of the values counted
_LAUNCHES_AT_RESET: dict | None = None  # kernels/_build.LAUNCHES when the window opened
_LOCAL = threading.local()  # .stack: this thread's open spans


class _NoSpan:
    """What `span` returns while tracing is off: enters and exits, records
    nothing."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "device", "parent", "child_ns", "t0", "events", "range")

    def __init__(self, name: str, device) -> None:
        self.name, self.device = name, device

    def __enter__(self) -> None:
        import torch

        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        self.parent = stack[-1] if stack else None
        if self.device is not None:
            self.device = torch.device(self.device)
        elif self.parent is not None:
            self.device = self.parent.device
        self.child_ns = 0
        stack.append(self)
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        self.events = None
        if self.device is not None and self.device.type == "cuda" and torch.cuda.is_initialized():
            stream = torch.cuda.current_stream(self.device)
            self.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self.events[0].record(stream)
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc) -> bool:
        import torch

        t1 = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.device))
        self.range.__exit__(*exc)
        _LOCAL.stack.pop()
        dt = t1 - self.t0
        if self.parent is not None:
            self.parent.child_ns += dt
        rec = (self.name, None if self.parent is None else self.parent.name, dt, dt - self.child_ns,
               self.events, self.device)
        with _LOCK:
            _RECORDS.append(rec)
        return False


def span(name: str, device=None):
    """A context manager that records the span `name` inside a `tracing()`
    block, and does nothing (one flag test) outside one. `device` is where
    the span's work runs; without it a span takes its parent's. On a CUDA
    device the span also times the device's current stream."""
    if not _TRACING:
        return _NO_SPAN
    return _Span(name, device)


def count(name: str, k=1) -> None:
    """Add `k` to the counter `name` inside a `tracing()` block; nothing
    outside one. A tensor `k` adds the sum of its values into a tensor on its
    own device, never read before `collect()`: a bool tensor counts its
    true values."""
    if not _TRACING:
        return
    add = k if isinstance(k, int) else k.sum()
    with _LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + add


def tracing_on() -> bool:
    """Whether spans and counters record now: a caller tests it before it
    computes a value only a counter would read."""
    return _TRACING


def _launches() -> dict:
    from ..kernels import _build

    with _build.LAUNCH_LOCK:
        return dict(_build.LAUNCHES)


@contextmanager
def tracing() -> Iterator[None]:
    """Record spans and counters for the length of the block. What is
    recorded stays until `reset()`; the kernel launches `collect()` reports
    count from the first block after it."""
    global _TRACING, _LAUNCHES_AT_RESET
    with _LOCK:
        if _LAUNCHES_AT_RESET is None:
            _LAUNCHES_AT_RESET = _launches()
    was, _TRACING = _TRACING, True
    try:
        yield
    finally:
        _TRACING = was


def reset() -> None:
    """Forget every span and counter recorded, and count kernel launches
    from now."""
    global _LAUNCHES_AT_RESET
    with _LOCK:
        _RECORDS.clear()
        _COUNTS.clear()
        _LAUNCHES_AT_RESET = _launches()


def collect() -> dict:
    """Everything recorded since the last `reset()`, after one synchronise of
    each device that spans timed:

    - `spans`: per name, `count`, `host_s` (host seconds), `self_host_s`
      (host seconds less the part its child spans cover), `device_s` (the
      seconds between its two events on the device's stream, summed; None
      where the span never ran on a CUDA device) and `parent` (the name of
      the span it ran inside, None at the top; a tuple of the names where it
      ran inside several);
    - `counters`: per name, its total as a Python number (a device counter's
      read-back waits for its device);
    - `launches`: kernel launches by name (`kernels/_build.LAUNCHES`) since
      the last `reset()`, or since the first `tracing()` block before one.
    """
    import torch

    with _LOCK:
        records, counts, base = list(_RECORDS), dict(_COUNTS), _LAUNCHES_AT_RESET
    for dev in {dev for *_, ev, dev in records if ev is not None}:
        torch.cuda.synchronize(dev)
    spans: Dict[str, dict] = {}
    for name, parent, host_ns, self_ns, ev, _ in records:
        s = spans.setdefault(name, {"count": 0, "host_s": 0.0, "self_host_s": 0.0, "device_s": None,
                                    "parents": []})
        s["count"] += 1
        s["host_s"] += host_ns * 1e-9
        s["self_host_s"] += self_ns * 1e-9
        if ev is not None:
            s["device_s"] = (s["device_s"] or 0.0) + ev[0].elapsed_time(ev[1]) * 1e-3
        if parent not in s["parents"]:
            s["parents"].append(parent)
    for s in spans.values():
        parents = s.pop("parents")
        s["parent"] = parents[0] if len(parents) == 1 else tuple(parents)
    now = _launches()
    base = now if base is None else base
    return {
        "spans": spans,
        "counters": {k: v if isinstance(v, int) else v.item() for k, v in counts.items()},
        "launches": {k: now[k] - base.get(k, 0) for k in now},
    }


# --------------------------------------------------------------------------
# stage timing and the profiler
# --------------------------------------------------------------------------


class StageTimer:
    """Accumulates wall-clock per named stage; cheap enough for hot loops.

    The host clock alone: a stage that only enqueues device work ends before
    the work does, so a stage that is to count device time ends in a
    read-back or a synchronise. Inside a `tracing()` block each stage is
    also the span `span_prefix + name`."""

    def __init__(self, span_prefix: str = "gbm.") -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.span_prefix = span_prefix
        self._lock = threading.Lock()

    @contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            with span(self.span_prefix + name):
                yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.totals[name] = self.totals.get(name, 0.0) + dt
                self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {
                k: {"total_s": self.totals[k], "count": self.counts[k],
                    "mean_s": self.totals[k] / self.counts[k]}
                for k in self.totals
            }


@contextmanager
def torch_profile(logdir: str) -> Iterator[object]:
    """`torch.profiler` over the block (host ops, and the card's kernels where
    CUDA is there); writes `trace.json` under `logdir` for chrome://tracing or
    Perfetto, and yields the profiler for `key_averages()`. Inside a
    `tracing()` block the trace holds the program's `gbm.` spans too."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
