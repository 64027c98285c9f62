#!/usr/bin/env python3
"""Weak-scaling harness of the port's mesh paths, the twin of
scripts/weak_scaling.py.

A fixed marker shard per rank and a growing rank count: D = 1, 2, 4, 8 ranks
run the sharded GRM (`sharded_grm`, K1 on each rank's int8 dosage shard on a
card), one marker-sharded BayesC Gibbs segment (`sharded_gibbs_regression`,
block_size=64; K3 on each rank's shard on a card) and the matrix-free CG
GBLUP (`sharded_gblup_cg`), and the harness reports the seconds of each
stage and the efficiency T(1)/T(D) (weak-scaling ideal: constant time,
efficiency 1.0).

The D ranks are threads of one process (`parallel/mesh.py:run_ranks`) over
gloo groups, sharing one device: on a card every collective is staged
through the host and the ranks' kernels run one after another on its one
stream. So, as the JAX harness says of its virtual CPU mesh, the output is a
correctness-shaped trend (the sharded programs run and keep the work per
rank fixed as D grows), not a hardware-scaling claim. The efficiencies are
also given normalized by the oversubscription max(1, D / units), where the
units the ranks share are the host's cores on the CPU and the one card on a
card.

The panel is called dosages (rng(0), {0, 1, 2}): the GRM takes them as int8,
the chain and CG as dosages / 2 in float32. It is made once per D on the
device, so the stages time the sharded work and not the upload. Each stage
runs once to warm up, then once timed on every rank between a barrier and a
read-back; a stage's time is the slowest rank's.

Usage, from the root of a checkout:  python3 scripts/torch_weak_scaling.py
(D = 1, 2, 4, 8 on the card; JSON lines; imported by tests/test_torch_parallel.py
and chip_smoke.py).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def run_weak_scaling(
    device_counts=(1, 2, 4, 8),
    n: int = 256,
    p_per_device: int = 2048,
    gibbs_iters: int = 4,
    cg_iters: int = 10,
    emit=print,
    device="cuda",
):
    """Run the three sharded stages at each D with p = p_per_device * D on
    D thread ranks sharing `device`.

    Returns {D: {stage: seconds}}; `emit` receives one JSON line per (D,
    stage) plus a final efficiency summary line."""
    import numpy as np
    import torch

    from genomicbreedingmodels_tpu_torch.device import resolve_device
    from genomicbreedingmodels_tpu_torch.parallel.mesh import run_ranks
    from genomicbreedingmodels_tpu_torch.parallel.sharded import (
        sharded_gblup_cg,
        sharded_gibbs_regression,
        sharded_grm,
    )

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    n_cores = os.cpu_count() or 1
    units = 1 if cuda else n_cores

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def timed(call):
        """Rank body: warm-up, barrier, the timed call ending in a read-back."""
        def body(mesh):
            call(mesh)
            mesh.barrier()
            sync()
            t0 = time.perf_counter()
            call(mesh)
            sync()
            return time.perf_counter() - t0
        return body

    rng = np.random.default_rng(0)
    results = {}
    for D in device_counts:
        p = p_per_device * D
        D8 = torch.from_numpy(rng.integers(0, 3, size=(n, p)).astype(np.int8)).to(dev)
        X = D8.to(torch.float32).mul_(0.5)
        y = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(dev)
        stages = {
            # per-rank Gram of the local shard (K1) + one n x n all-reduce
            "grm": lambda m: float(sharded_grm(D8, m)[0, 0]),
            # per-rank block scans + one n-vector all-reduce per block turn
            "gibbs": lambda m: sharded_gibbs_regression(
                X, y, m, axis="mp", model="BayesC", n_iter=gibbs_iters, n_burnin=0,
                block_size=64),
            # two local GEMVs + one n-vector all-reduce per iteration
            "cg": lambda m: float(sharded_gblup_cg(X, y, 0.1, m, axis="mp", n_iter=cg_iters)[1][0]),
        }
        times = {stage: max(run_ranks(timed(call), shape=(1, D), device=dev))
                 for stage, call in stages.items()}
        results[D] = times
        for stage, dt in times.items():
            emit(json.dumps({
                "harness": "weak_scaling", "devices": D, "stage": stage,
                "p_total": p, "seconds": dt,
            }))
        del D8, X, y
    base = results[device_counts[0]]
    summary = {
        "harness": "weak_scaling", "summary": True,
        "note": (f"up to {max(device_counts)} thread ranks sharing one {dev.type} device, gloo "
                 "collectives (staged through the host on a card); correctness-shaped trend only"),
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "cores": n_cores, "units_shared": units,
    }
    for stage in base:
        summary[f"efficiency_{stage}"] = {
            D: round(base[stage] / results[D][stage], 3) for D in device_counts
        }
        summary[f"efficiency_{stage}_core_normalized"] = {
            D: round(base[stage] / results[D][stage] * max(1, D / units), 3)
            for D in device_counts
        }
    emit(json.dumps(summary))
    return results


if __name__ == "__main__":
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    run_weak_scaling()
    sys.exit(0)
