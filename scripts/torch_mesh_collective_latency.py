#!/usr/bin/env python3
"""What one collective of the port's thread-rank mesh costs, and how much of
the marker-sharded chain's time it is.

Usage, from the root of a checkout:  python3 scripts/torch_mesh_collective_latency.py

`parallel/mesh.py:run_ranks` runs D ranks as threads over gloo groups; a
gloo collective of a CUDA tensor is staged through the host, and a rank
waiting on one polls an abort flag (so a failed rank fails the others at
once). This script times, over two thread ranks:

1. the all-reduce of a 10,000-float vector (the Gibbs chain's per-block
   residual n-vector at n = 10,000) on the CPU and on the card, through the
   mesh's polling wait and through a plain blocking `work.wait()`;
2. the marker-sharded BayesC chain at 10,000 x 102,000, bs=600, 10 sweeps
   (2 of burn-in), with each wait, after one warm-up call that builds the
   kernels; and the same 10 sweeps on one rank, where the chain makes no
   per-block collective.

It prints the card's name and power limit first. Needs one CUDA card.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from genomicbreedingmodels_tpu_torch.parallel import mesh as mesh_mod
    from genomicbreedingmodels_tpu_torch.parallel.mesh import run_ranks
    from genomicbreedingmodels_tpu_torch.parallel.sharded import sharded_gibbs_regression

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    polling = mesh_mod.Mesh._wait

    def plain(self, work):
        work.wait()

    def allreduce_us(dev: str, reps: int = 400) -> float:
        def rank(m):
            t = torch.ones(10_000, device=dev)
            m.allreduce(t)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                m.allreduce(t)
            return (time.perf_counter() - t0) / reps * 1e6
        return max(run_ranks(rank, shape=(1, 2), device=dev))

    for name, wait in (("polling (the mesh's)", polling), ("plain work.wait()", plain)):
        mesh_mod.Mesh._wait = wait
        print(f"all-reduce of 10,000 floats over 2 thread ranks, {name}: "
              f"CPU tensor {allreduce_us('cpu'):.1f} us, CUDA tensor {allreduce_us('cuda'):.1f} us "
              f"[{card}]")
    mesh_mod.Mesh._wait = polling

    g = torch.Generator(device="cuda").manual_seed(0)
    X = torch.randint(0, 3, (10_000, 102_000), generator=g, device="cuda").float().mul_(0.5)
    y = torch.randn(10_000, device="cuda", generator=g)

    def chain(D: int) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_ranks(lambda m: sharded_gibbs_regression(X, y, m, model="BayesC", n_iter=10, n_burnin=2,
                                                     block_size=600), shape=(1, D), device="cuda")
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    chain(1)  # builds the kernels
    print(f"sharded BayesC 10000x102000 bs=600, 10 sweeps, 1 rank (no per-block collective): "
          f"{chain(1):.3f} s [{card}]")
    for name, wait in (("polling (the mesh's)", polling), ("plain work.wait()", plain)):
        mesh_mod.Mesh._wait = wait
        print(f"sharded BayesC 10000x102000 bs=600, 10 sweeps, 2 ranks sequential, {name}: "
              f"{chain(2):.3f} s, {10 * 2 * 85} block turns [{card}]")
    mesh_mod.Mesh._wait = polling
    return 0


if __name__ == "__main__":
    sys.exit(main())
