"""Structured logging and stage timing, copied from
genomicbreedingmodels_tpu/utils/logging.py (`get_logger`, `StageTimer`), with
`torch_profile` in place of `jax_profile`.

`StageTimer` takes a lock around each update: the CV executor's worker
threads time their jobs into one timer.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterator

__all__ = ["StageTimer", "get_logger", "torch_profile"]

_LOGGER = logging.getLogger("gbm_tpu")


def get_logger() -> logging.Logger:
    if not _LOGGER.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
        _LOGGER.addHandler(h)
        _LOGGER.setLevel(logging.INFO)
    return _LOGGER


class StageTimer:
    """Accumulates wall-clock per named stage; cheap enough for hot loops.

    The host clock alone: a stage that only enqueues device work ends before
    the work does, so a stage that is to count device time ends in a
    read-back or a synchronise."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._lock = threading.Lock()

    @contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
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
    Perfetto, and yields the profiler for `key_averages()`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
