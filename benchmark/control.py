#!/usr/bin/env python3
"""Readings for the limits of a cell's check: the program's (sound runs)
and its control's, at the cell's own size, many seeds in one process.

    python3 benchmark/control.py --workload <name> --seeds 11,12,13 \\
        [--control-seeds 11,12,13] [--seconds 5]

For every seed: the cell's set-up, a short window of its own requests at
its own load, and the numbers its check compares (the program's readings);
for the control seeds also the same numbers of the control, the reference
computed one precision below the configuration's and put in the program's
place. One JSON line per seed and side on standard output. Needs the card;
the benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import harness  # noqa: E402


def readings(workload: str, seeds, control_seeds, seconds: float, device: str = "cuda",
             config_overrides=None, traffic_overrides=None):
    """Yield (seed, side, {number: reading}) for every seed and side."""
    import torch

    harness.cache_env()
    cell, config, traffic = harness.resolve_cell(harness.load_manifest(), workload)
    config.update(config_overrides or {})
    traffic.update(traffic_overrides or {})
    route = harness.route_module(traffic)
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    from genomicbreedingmodels_tpu_torch.kernels import _build

    for seed in sorted(set(seeds) | set(control_seeds)):
        ctx = harness.Ctx(cell, config, traffic, seed, seconds, False, dev, time.perf_counter())
        route.setup(ctx)
        before = dict(_build.LAUNCHES)
        route.window(ctx)
        ctx.launches = {k: _build.LAUNCHES[k] - before[k] for k in before}
        route.release(ctx)
        if seed in seeds:
            yield seed, "program", {k: v for k, (v, _) in route.check(ctx).items()}
        if seed in control_seeds:
            yield seed, "control", route.control(ctx)
        del ctx
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds of the program's readings")
    ap.add_argument("--control-seeds", default="", help="comma-separated seeds of the control's readings")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        harness.note("# the control runs on the card: no CUDA device")
        return 2
    seeds = [int(s) for s in args.seeds.split(",") if s]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    for seed, side, nums in readings(args.workload, seeds, cseeds, args.seconds):
        print(json.dumps({"workload": args.workload, "seed": seed, "side": side, "readings": nums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
