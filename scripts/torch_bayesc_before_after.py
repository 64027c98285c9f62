#!/usr/bin/env python3
"""Time the port's single-chain BayesC at size against an earlier checkout, in turns, on one card.

Usage, from the root of a checkout, on a machine with one NVIDIA Hopper card:

    python3 scripts/torch_bayesc_before_after.py --before DIR [--rounds 1]

DIR is the root of an earlier checkout of the repository (for example the
parent commit unpacked with `git archive` into a git-ignored directory under
`build/`). The script runs `gibbs_regression` with BayesC, as `chip_smoke.py`'s
phase 7 does (10,000 x 102,000 dosages/2 made on the card from a seed, 1 %
causal, h2 ~ 0.5, block_size 600, 60 sweeps of which 20 burn-in), once in a
process of its own per turn and tree: before, after, after, before, for
`--rounds` rounds. Each turn times a first call (the kernels of that tree
built beforehand) and a warm call by the host clock; the call ends in the
chain's read-back. It prints the card's name and power limit, one line per
turn (first and warm seconds, the warm call's sweeps seconds, K3 launches,
the within-block path) and the warm marker-updates/s = sweeps·p/t of each
tree, then a JSON line. It exits 1 if a turn fails or launches K3 other
than sweeps x blocks times. It imports neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def child(root: str, n: int, p: int, sweeps: int, burn: int, bs: int, seed: int) -> None:
    """One turn: the tree at `root` builds its kernels, then two timed calls."""
    sys.path.insert(0, root)
    import torch

    import genomicbreedingmodels_tpu_torch as gbm
    from genomicbreedingmodels_tpu_torch.kernels import _build

    _build.load()  # the tree's kernels, built outside the timed calls
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    X = torch.randint(0, 3, (n, p), dtype=torch.int8, device=dev, generator=gen)
    X = X.to(torch.float32).mul_(0.5)
    beta = torch.randn(p, device=dev, generator=gen)
    beta *= torch.rand(p, device=dev, generator=gen) < 0.01
    g = X @ beta
    y = g + torch.randn(n, device=dev, generator=gen) * g.std()
    torch.cuda.synchronize()
    out = {"package": gbm.__file__}
    for call in ("first", "warm"):
        k0 = gbm.LAUNCHES["gibbs_group"]
        t0 = time.perf_counter()
        _, b_hat, diag = gbm.gibbs_regression(X, y, model="BayesC", block_size=bs, n_iter=sweeps,
                                              n_burnin=burn, device=dev)
        out[call] = time.perf_counter() - t0
        out[f"{call}_sweeps_s"] = diag["stage_seconds"]["sweeps"]
        out["launches"] = gbm.LAUNCHES["gibbs_group"] - k0
        out["path"] = diag["update"]
        out["finite"] = bool(torch.isfinite(torch.from_numpy(b_hat)).all())
    print("TURN " + json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--before", help="root of the earlier checkout (required)")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--n", type=int, default=10_000)
    ap.add_argument("--p", type=int, default=102_000)
    ap.add_argument("--sweeps", type=int, default=60)
    ap.add_argument("--burn", type=int, default=20)
    ap.add_argument("--block", type=int, default=600)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    a = ap.parse_args()
    sizes = (a.n, a.p, a.sweeps, a.burn, a.block, a.seed)
    if a.child:
        child(a.child, *sizes)
        return 0
    if not a.before:
        ap.error("--before is required")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    trees = {"before": str(Path(a.before).resolve()), "after": str(ROOT)}
    launches = a.sweeps * -(-a.p // a.block)
    warm, ok = {"before": [], "after": []}, True
    for _ in range(a.rounds):
        for name in ("before", "after", "after", "before"):
            proc = subprocess.run(
                [sys.executable, __file__, "--child", trees[name], "--n", str(a.n), "--p", str(a.p),
                 "--sweeps", str(a.sweeps), "--burn", str(a.burn), "--block", str(a.block),
                 "--seed", str(a.seed)],
                capture_output=True, text=True, cwd=trees[name])
            lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("TURN ")]
            if proc.returncode != 0 or not lines:
                print(f"{name}: the turn failed (exit {proc.returncode})\n{proc.stderr[-4000:]}")
                ok = False
                continue
            r = json.loads(lines[-1][5:])
            good = r["launches"] == launches and r["finite"]
            ok &= good
            warm[name].append(r["warm"])
            print(f"{name}: first {r['first']:.3f} s, warm {r['warm']:.3f} s (sweeps "
                  f"{r['warm_sweeps_s']:.3f} s), K3 launches {r['launches']} (expected {launches}), "
                  f"path {r['path']}, {r['package']} {card}")
    summary = {name: {"warm_s": ts, "updates_per_s": [a.sweeps * a.p / t for t in ts]}
               for name, ts in warm.items()}
    for name, s in summary.items():
        if s["warm_s"]:
            print(f"{name}: warm median {statistics.median(s['warm_s']):.3f} s, "
                  f"{statistics.median(s['updates_per_s']):.6g} marker-updates/s {card}")
    print(json.dumps({"card": card, "n": a.n, "p": a.p, "sweeps": a.sweeps, "block": a.block,
                      **summary}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
