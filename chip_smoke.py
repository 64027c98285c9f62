#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Usage, from the root of a checkout:  python3 chip_smoke.py

1. environment: torch / CUDA versions, the card's name and power limit,
   nvcc, whether triton imports;
2. builds the port's kernels from `genomicbreedingmodels_tpu_torch/csrc`,
   prints each kernel's registers and spills from ptxas and, where cuobjdump
   exists, its count of wgmma (IGMMA / HGMMA) and TMA (UTMALDG) instructions;
3. K1 (`gram_tri_int8`) against its plain version: bit-equal, strict upper
   triangle zero, exactly symmetric once mirrored; on random dosages and on
   the called panel's own training dosages that phase 6's `gblup` uses;
   timed at 8192x262144 beside its bound and `torch._int_mm(D, D.t())`;
4. K2 (`gram_tri_float`, f32 and bf16) against its plain version (a float64
   product): max |err| <= 1e-5 · max|G|; on random panels and on phase 6's
   continuous training panel; timed at 1844x16384 and 2048x32768 beside its
   bound and `torch.mm(X, X.T)` (TF32 off; bf16 with an f32 output where
   this torch's mm takes `out_dtype`);
5. the headline step at n=8192, p=262144 int8: `gram_dosage_lower` (K1) then
   `gblup_solve_lower`, checked against the plain-version path on the card
   and timed against it;
   (K3) K3 (`grouped_block_update`, the grouped Gibbs block update) against
   its plain version on the same inputs and noise: identical selections,
   draws within K3_TOL; at bs=600 with K=6 and K=8, at bs=258 with K=6 and the
   last 5 markers invalid, at bs=1024 with K=8 (the largest "auto" block,
   every Cb row staged in shared memory) and at bs=8192 with K=8 and the last
   7 markers invalid (the rows staged in part, the rest read from L2); timed
   per block and per group at bs=600, K=6 and K=8, with Cb cold in L2, as
   the chain finds it, and warm;
6. the public API: simulate -> `gblup` on a continuous panel (K2) and on the
   called panel (K1) -> `predict`, each checked against the same calls with
   device="cpu" (the plain versions);
7. the Bayesian alphabet at size: `gibbs_regression(model="BayesC")` on a
   device-resident 10,000 x 102,000 dosage panel (BASELINE config 3, as
   bench.py builds it) with block_size=600 for 60 sweeps, twice (first and
   warm call): K3 launched once per block and sweep, finite b and sigma_e2,
   cor(X b, g_true) >= 0.5; marker-updates/s, prep against sweeps, peak memory;
   and, at the very end of the script, one call of 5 sweeps under
   `torch.profiler`: the device's busy share (kernel time over the call's
   wall time) and K3's share of kernel time;
8. chain-level agreement on the bench's ESS panel (512 x 4096): BayesC for
   400 sweeps through K3 ("auto") and through the plain grouped draw on the
   card ("grouped"): GEBV correlation >= 0.98, sigma_e2 posterior means within
   25 %;
9. the public API again: `bayesc` (K3) and `bayesian_ridge` (joint block
   draw, no kernel) on phase 6's panel -> `predict`;
10. cross-validation (`cv_phase`): `cvbulk_batched` and `cvbulk` on the card
   against device="cpu" at 256x2048, the JAX bench's `cv` cell at 2048x32768
   cold and warm, `cvbulk` over six models at that width (K2 and K3 launched
   by the jobs) and again with two workers, and `validate`'s leakage check.

Launch counters are reset after the comparisons of phases 3-4 and K3 and read
after phase 9; every kernel must have launched on that main path. Then K3 is
held against its plain version once more, on the first block of phase 7's
chain as the chain called it. Phase 10 runs with the counters reset again
and read after it, and every kernel must have launched there too. Then
phase 7's panel goes through the profiler.
The second-to-last line is the kernels' JSON record, the last line the
device record. Any failed check raises, so the script exits non-zero and
prints no result. TF32 is off for every float32 matmul (the plain versions
must not round to TF32).

Each kernel's `bound_ms` is the least time the card could take for the same
work: the larger of its operations over the published H100 SXM peak for
their type (`PEAK`) and its bytes (each input read once, each output written
once) over 3.35 TB/s. K2 in f32 takes three TF32 products on the tensor
cores, so its bound counts those at 495 TFLOP/s; `ffma_bound_ms` gives the
bound of the one f32 product at the 67 TFLOP/s of FFMA. `library_ms` times
one PyTorch call computing the same function (the port never calls it), or
is null where there is none.
"""

from __future__ import annotations

import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

N_HEAD, P_HEAD = 8192, 262_144
# λ = 0.1 on the per-marker scale K/p, as in entry(); on the raw dosage Gram
# (diagonal ~4e4) that is 0.1·p. λ = 0.1 on the raw scale leaves K + λI, whose
# centered part has an exact zero eigenvalue, within float32 rounding of
# singular: the factorisation fails and the GEBVs are NaN.
LAM = 0.1 * P_HEAD
K2_TOL = 1e-5  # max |kernel - plain| / max |plain|, f32 and bf16 (bf16 products are exact in f32)
GEBV_TOL = 1e-5  # headline GEBV: max |Δ| / max |plain|; K1 is exact, so only solve noise remains
COR_MIN = 0.9999  # gblup y_pred on the card vs device="cpu"
# K3 draws: max |kernel - plain| <= K3_TOL * max(1, max|b_new|), selections
# identical. The two sum in other orders (the kernel carries u - cdelta with
# fused multiply-adds, the plain version v / sigma_e2), and the running
# correlation carries that float32 rounding through all bs/K groups of a block.
K3_TOL = 1e-4
# Phase 10: CV on the card against device="cpu" (pooled y_pred correlation
# per model; ridge/gblup per-fold max |Δ y_pred| over std(y)), and
# n_workers=2 against n_workers=1 (max |Δ y_pred| over max |y_pred|).
CV_COR_MIN, CV_DUAL_TOL, WORKERS_TOL = 0.999, 1e-3, 1e-4
# BASELINE config 3 as bench.py:389-406 builds it: bs=600 divides p, no padding.
N_BIG, P_BIG, BS_BIG, SWEEPS_BIG, BURN_BIG = 10_000, 102_000, 600, 60, 10
# Published dense peaks of one H100 SXM at 700 W (operations/s) and its HBM rate (bytes/s).
PEAK = {"int8": 1979e12, "bf16": 989e12, "tf32": 495e12, "f32": 67e12}
HBM = 3.35e12


def bound(ops: float, peak: float, nbytes: float) -> tuple[float, str]:
    """(bound_ms, bound_by): the larger of ops/peak and bytes/HBM, in ms."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / HBM * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def gram_bound(n: int, p: int, kind: str, itemsize: int, products: int = 1) -> tuple[float, str]:
    """The lower half of X·Xᵀ: n(n+1)/2·p multiply-adds (2 operations each)
    per product the kernel takes (3 for K2's 3xTF32), the panel read once,
    the n(n+1)/2 4-byte lower triangle written once."""
    tri = n * (n + 1) / 2
    return bound(2.0 * tri * p * products, PEAK[kind], n * p * itemsize + 4.0 * tri)


def kernel_build_report(lib_path: Path) -> None:
    """ptxas registers/spills per kernel from the build log, and the wgmma and
    TMA instructions per kernel in the built library (cuobjdump)."""
    import shutil

    from genomicbreedingmodels_tpu_torch.kernels import _build

    tag = lib_path.stem.rsplit("_", 1)[1]  # libgbm_torch_kernels_<tag>.so
    fn = None
    for line in (lib_path.parent / f"build_{tag}.log").read_text().splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif fn and ("registers" in line or "spill" in line):
            print(f"  ptxas {fn}: {line.strip()}")
    tool = shutil.which("cuobjdump")
    beside_nvcc = Path(_build._nvcc()).with_name("cuobjdump")
    if tool is None and beside_nvcc.is_file():
        tool = str(beside_nvcc)
    if tool is None:
        print("cuobjdump not found")
        return
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split(":", 1)[1].strip()
            counts[fn] = {"IGMMA": 0, "HGMMA": 0, "UTMALDG": 0}
        elif fn:
            for op in counts[fn]:
                counts[fn][op] += f" {op}." in line or f" {op} " in line
    for fn, c in counts.items():
        if "gram_tri" in fn:
            print(f"  sass {fn}: {c}")
            check(c["IGMMA"] + c["HGMMA"] > 0 and c["UTMALDG"] > 0,
                  f"{fn} is a wgmma kernel fed by TMA")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over `reps` calls after one warm-up, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def wall_median_s(fn, reps: int) -> float:
    """Median host seconds of `reps` warm calls, synchronised around each."""
    import torch

    fn()
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


def profile_call(fn, kernel: str, top: int = 4) -> tuple[float, float, float, list]:
    """One call of `fn` under torch.profiler: (wall seconds, seconds of device
    kernel time, seconds of it in kernels whose name holds `kernel`, the `top`
    device events with the most time as (seconds, name)). The device time is
    the sum of the device events' self times, as the profiler's own table
    totals it: a CPU op's self device time repeats that of the kernels it
    launched, which are events of their own."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    total = mine = 0.0
    events = []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:  # torch before the device-neutral names
            us = getattr(e, "self_cuda_time_total", 0.0)
        total += us
        if kernel in e.key:
            mine += us
        events.append((us / 1e6, e.key))
    return wall, total / 1e6, mine / 1e6, sorted(events, reverse=True)[:top]


def gumbel(shape, dev, gen):
    import torch

    u = torch.rand(shape, device=dev, generator=gen).clamp_(1e-12, 1.0 - 1e-7)
    return -torch.log(-torch.log(u))


def k3_inputs(dev, gen, bs: int, K: int, n: int = 1000, n_invalid: int = 0) -> list:
    """One block as the chain hands it to K3: Cb = X_bᵀX_b and u = X_bᵀr of a
    random centered dosage panel (n x bs), sparse effects, the noise."""
    import torch

    X = torch.randint(0, 3, (n, bs), device=dev, generator=gen).float() / 2
    X -= X.mean(0)
    val = torch.ones(bs, device=dev)
    if n_invalid:
        val[-n_invalid:] = 0.0
        X[:, -n_invalid:] = 0.0  # padded markers carry zero Gram rows
    b = torch.randn(bs, device=dev, generator=gen) * val
    b *= torch.rand(bs, device=dev, generator=gen) < 0.1
    r = torch.randn(n, device=dev, generator=gen)
    return [X.T @ X, X.T @ r, b, torch.full((bs,), 0.02, device=dev), val,
            torch.randn(bs, device=dev, generator=gen), gumbel((bs // K, 1 << K), dev, gen),
            torch.tensor(0.9, device=dev), torch.tensor(0.1, device=dev)]


def k3_check(args: list, K: int, label: str) -> float:
    """K3 against its plain version on the same inputs; returns max |err|."""
    import torch

    from genomicbreedingmodels_tpu_torch.kernels.gibbs_group import (
        grouped_block_update,
        grouped_block_update_plain,
    )

    d, b, incl = grouped_block_update(*args, K=K)
    d_p, b_p, incl_p = grouped_block_update_plain(*args, K=K)
    torch.cuda.synchronize()
    err = max(float((b - b_p).abs().max()), float((d - d_p).abs().max()))
    tol = K3_TOL * max(1.0, float(b_p.abs().max()))
    same = torch.equal(incl, incl_p)
    invalid = args[4] == 0
    zero_invalid = not bool(b[invalid].any() or incl[invalid].any())
    finite = bool(torch.isfinite(b).all() and torch.isfinite(d).all())
    print(f"K3 {label}: incl_identical={same} included={int(incl.sum())}/{len(b)} "
          f"max_abs_err={err:.3g} (tol {tol:.3g}) invalid_zero={zero_invalid} finite={finite}")
    check(same and err <= tol and zero_invalid and finite, f"K3 at {label}")
    return err


def cv_phase(gbm, dev, card: str, width=(2048, 32_768)) -> dict:
    """Phase 10, cross-validation on the card, with the launch counters set
    to 0 just before it; returns the counts it launched. `width` is (n, p)
    of parts (b)-(c); a rehearsal on the host passes a small one.

    (a) at n=256, p=2048 (simulated, called to {0, ½, 1}, so gblup's GRM
    takes K1): `cvbulk_batched` (ridge, gblup, lasso) and `cvbulk` (ols,
    ridge, lasso, gblup), each on the card and with device="cpu": the same
    tags and validation entries, pooled y_pred correlation >= CV_COR_MIN per
    model, ridge and gblup per fold within CV_DUAL_TOL·std(y);
    (b) the JAX bench's `cv` cell (bench.py:610-659): 2048x32768 uniform
    panel from rng(11), 1 % causal, ridge/gblup/lasso, 3x5 folds,
    store_effects=False, cold (device caches cleared) then warm, with
    LAST_TIMER's stage split;
    (c) `cvbulk` at the same width, 1x5 folds, one call per model (ols,
    ridge, lasso, gblup, bayesc, mlp; chains cut to 200 sweeps, 50 burn-in):
    30 CVs, no model-fitting warning, K2 and K3 launched by these calls;
    then ridge and bayesc again with n_workers=2, each y_pred within
    WORKERS_TOL·max|y_pred| of the n_workers=1 run;
    (d) `validate` raises on a train/validation overlap.
    """
    import dataclasses
    import warnings

    import numpy as np
    import torch

    from genomicbreedingmodels_tpu_torch.cv import batched as cv_batched
    from genomicbreedingmodels_tpu_torch.utils import config

    def keys(cvs):
        return [(cv.fit.trait, cv.fit.model, cv.replication, cv.fold) for cv in cvs]

    def harness_warnings(rec):
        msgs = [str(w.message) for w in rec]
        return [m for m in msgs if "model-fitting error" in m or "cross-validation error" in m], msgs

    def run(fn, *args, **kw):
        """fn(*args, **kw) with its warnings recorded and its wall seconds
        (the call ends in read-backs); fails on a harness warning."""
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            if torch.device(dev).type == "cuda":
                torch.cuda.synchronize()
            t = time.perf_counter() - t0
        bad, msgs = harness_warnings(rec)
        for m in msgs:
            print(f"  warning: {m[:200]}")
        check(not bad, f"{getattr(fn, '__name__', fn)}: no model-fitting warning")
        return out, t

    gbm.reset_launches()

    # -- (a) exactness at small size: the card against device="cpu" --------------
    g = gbm.simulate_genomes(n=256, l=2048, seed=5)
    trials, _ = gbm.simulate_trials(g, f_add_dom_epi=np.array([[0.4, 0.05, 0.05]]), seed=5)
    ph = gbm.extract_phenomes(trials)
    g = gbm.Genomes(entries=g.entries, populations=g.populations, loci_alleles=g.loci_alleles,
                    allele_frequencies=np.rint(2.0 * g.allele_frequencies) / 2.0)
    sd = float(np.std(ph.phenotypes[:, 0]))
    for label, fn, models in (("cvbulk_batched", gbm.cvbulk_batched, ("ridge", "gblup", "lasso")),
                              ("cvbulk", gbm.cvbulk, ("ols", "ridge", "lasso", "gblup"))):
        (card_cvs, _), t_card = run(fn, g, ph, models=models, n_replications=1, n_folds=3, seed=7,
                                    device=dev)
        (cpu_cvs, _), t_cpu = run(fn, g, ph, models=models, n_replications=1, n_folds=3, seed=7,
                                  device="cpu")
        check(keys(card_cvs) == keys(cpu_cvs) and len(card_cvs) == 3 * len(models),
              f"{label} 256x2048: the same CV tags on the card and the CPU")
        check(all(np.array_equal(a.validation_entries, b.validation_entries)
                  for a, b in zip(card_cvs, cpu_cvs)), f"{label} 256x2048: the same validation entries")
        parts, verdicts = [], []
        for m in models:
            pairs = [(a, b) for a, b in zip(card_cvs, cpu_cvs) if a.fit.model == m]
            ya = np.concatenate([a.y_pred for a, _ in pairs])
            yb = np.concatenate([b.y_pred for _, b in pairs])
            cor = float(np.corrcoef(ya, yb)[0, 1])
            dmax = max(float(np.abs(a.y_pred - b.y_pred).max()) for a, b in pairs) / sd
            parts.append(f"{m} cor={cor:.6f} max|Δ|/sd={dmax:.3g}")
            verdicts.append((np.all(np.isfinite(ya)) and cor >= CV_COR_MIN, f"{label} {m}: card vs cpu cor"))
            if m in ("ridge", "gblup"):
                verdicts.append((dmax <= CV_DUAL_TOL, f"{label} {m}: card vs cpu per fold"))
        print(f"CV (a) {label} 256x2048 called, 1x3 folds, card vs device='cpu': " + "; ".join(parts)
              + f"; card {t_card:.3f} s, cpu {t_cpu:.3f} s {card}")
        for ok, what in verdicts:
            check(ok, what)

    # -- (b) the bench's cv cell at full width ----------------------------------------
    (n, p), reps, folds = width, 3, 5
    models = ("ridge", "gblup", "lasso")
    rng = np.random.default_rng(11)
    freq = rng.uniform(size=(n, p)).astype(np.float32)
    G = gbm.Genomes(entries=np.array([f"e{i:05d}" for i in range(n)]),
                    populations=np.array(["pop_1"] * n),
                    loci_alleles=np.array([f"chr1\t{i}\tA|T\tA" for i in range(p)]),
                    allele_frequencies=freq)
    beta = rng.normal(size=p) * (rng.uniform(size=p) < 0.01)
    yy = freq @ beta
    yy = yy + rng.normal(size=n) * yy.std()
    P = gbm.Phenomes(entries=G.entries, populations=G.populations, traits=np.array(["t"]),
                     phenotypes=yy[:, None])
    gbm.clear_device_caches()
    before = dict(gbm.LAUNCHES)
    for call in ("cold", "warm"):
        (cvs, _), t = run(gbm.cvbulk_batched, G, P, models=models, n_replications=reps, n_folds=folds,
                          store_effects=False, device=dev)
        split = " ".join(f"{k}={v['total_s']:.3f}s" for k, v in cv_batched.LAST_TIMER.summary().items())
        print(f"CV (b) cvbulk_batched {n}x{p} {reps}x{folds} folds x {len(models)} models, {call}: "
              f"{t:.3f} s ({split}) {card}")
        check(len(cvs) == reps * folds * len(models), f"cv cell {call}: 45 CVs")
        check(all(np.isfinite(cv.metrics["cor"]) and np.all(np.isfinite(cv.y_pred)) for cv in cvs),
              f"cv cell {call}: finite metrics")
    cors = {m: float(np.mean([cv.metrics["cor"] for cv in cvs if cv.fit.model == m])) for m in models}
    print("CV (b) mean validation cor: " + " ".join(f"{m}={c:.4f}" for m, c in cors.items())
          + f"; K2 launches {gbm.LAUNCHES['gram_tri_float'] - before['gram_tri_float']}")

    # -- (c) the executor at the same width ---------------------------------------------
    cfg = config.get_config()
    config.set_config(dataclasses.replace(cfg, mcmc_n_iter=200, mcmc_n_burnin=50))
    try:
        before = dict(gbm.LAUNCHES)
        one = {}
        for m in ("ols", "ridge", "lasso", "gblup", "bayesc", "mlp"):
            k0 = dict(gbm.LAUNCHES)
            (cvs, _), t = run(gbm.cvbulk, G, P, models=[m], n_replications=1, n_folds=5, seed=3,
                              n_workers=1, device=dev)
            one[m] = cvs
            ks = {k: gbm.LAUNCHES[k] - k0[k] for k in k0 if gbm.LAUNCHES[k] > k0[k]}
            cor = float(np.mean([cv.metrics["cor"] for cv in cvs]))
            print(f"CV (c) cvbulk {m} {n}x{p} 1x5 folds: {t:.3f} s ({t / 5:.3f} s per fit+validate), "
                  f"mean validation cor {cor:.4f}, launches {ks} {card}")
        launched = {k: gbm.LAUNCHES[k] - before[k] for k in before}
        check(sum(len(c) for c in one.values()) == 30, "cvbulk at width: 30 CVs")
        if torch.device(dev).type == "cuda":  # (a host rehearsal launches no kernel)
            check(launched["gram_tri_float"] > 0 and launched["gibbs_group"] > 0,
                  "cvbulk at width launched K2 and K3")
        (two, _), t2 = run(gbm.cvbulk, G, P, models=["ridge", "bayesc"], n_replications=1, n_folds=5,
                           seed=3, n_workers=2, device=dev)
    finally:
        config.set_config(cfg)
    check(len(two) == 10, "n_workers=2: 10 CVs")
    worst = 0.0
    for cv in two:
        ref = next(c for c in one[cv.fit.model] if c.fold == cv.fold)
        check(np.array_equal(ref.validation_entries, cv.validation_entries), "n_workers=2: same folds")
        worst = max(worst, float(np.abs(cv.y_pred - ref.y_pred).max() / np.abs(ref.y_pred).max()))
    print(f"CV (c) ridge+bayesc n_workers=2: {t2:.3f} s, max|Δ y_pred|/max|y_pred| against "
          f"n_workers=1 {worst:.3g} {card}")
    check(worst <= WORKERS_TOL, "n_workers=2 equals n_workers=1")

    # -- (d) validate refuses leakage on the card ------------------------------------------
    fit = one["ridge"][0].fit
    try:
        gbm.validate(fit, G, P, idx_validation=G.entry_indices(fit.entries[:5].tolist()), device=dev)
        leak_raised = False
    except ValueError as err:
        leak_raised = "data leakage" in str(err)
    check(leak_raised, "validate raises on train/validation overlap")
    print("CV (d) validate on overlapping entries: raised the leakage error")

    return dict(gbm.LAUNCHES)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs one CUDA card",
              file=sys.stderr)
        return 1

    import numpy as np

    import genomicbreedingmodels_tpu_torch as gbm
    from genomicbreedingmodels_tpu_torch.kernels import _build
    from genomicbreedingmodels_tpu_torch.kernels.gibbs_group import (
        grouped_block_update,
        grouped_block_update_plain,
    )
    from genomicbreedingmodels_tpu_torch.kernels.gram_tri import (
        gram_tri_float,
        gram_tri_float_plain,
        gram_tri_int8,
        gram_tri_int8_plain,
    )
    from genomicbreedingmodels_tpu_torch.ops.chol import gblup_solve_lower
    from genomicbreedingmodels_tpu_torch.ops.grm import (
        _center_gram_lower,
        encode_dosage,
        gram_dosage_lower,
    )

    t_main = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # -- 1. environment ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"device {torch.cuda.get_device_name(0)}  count {torch.cuda.device_count()}")
    print(smi)
    nvcc = _build._nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True, check=True)
    print(f"nvcc {nvcc}: {ver.stdout.strip().splitlines()[-1]}")
    try:
        import triton  # noqa: F401

        print(f"triton {triton.__version__} imports")
    except ImportError as err:
        print(f"triton does not import: {err}")
    print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")
    kernel_build_report(_build.build())

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    records = {}

    # Phase 6's panels, simulated up front so phases 3-4 can check K1 and K2
    # on the very training panels `gblup` hands them.
    t0 = time.perf_counter()
    genomes = gbm.simulate_genomes(n=2048, l=16_384, seed=42)
    trials, _ = gbm.simulate_trials(genomes, f_add_dom_epi=np.array([[0.4, 0.05, 0.05]]), seed=42)
    phenomes = gbm.extract_phenomes(trials)
    print(f"simulate 2048 x 16384: {time.perf_counter() - t0:.2f} s (host)")
    perm = np.random.default_rng(7).permutation(genomes.n)
    test, train = np.sort(perm[: genomes.n // 10]), np.sort(perm[genomes.n // 10 :])
    n_train = len(train)
    called = gbm.Genomes(
        entries=genomes.entries, populations=genomes.populations,
        loci_alleles=genomes.loci_alleles,
        allele_frequencies=np.rint(2.0 * genomes.allele_frequencies) / 2.0,
    )

    def train_panel(g):
        return gbm.extractxyetc(g, phenomes, idx_entries=train, add_intercept=False)[0]

    # What gblup's GRM hands K1 and K2 (core/grm.py -> ops/grm.py).
    D_called = encode_dosage(train_panel(called), ploidy=2)
    check(D_called is not None, "the called panel encodes as int8 dosages")
    X_cont = train_panel(genomes).astype(np.float32)

    # -- 3. K1 against its plain version --------------------------------------
    k1_inputs = [(64, 512), (129, 257), (1000, 4099), (n_train, 16_384),
                 "gblup called panel", (N_HEAD, P_HEAD)]
    for what in k1_inputs:
        if what == "gblup called panel":
            D = torch.from_numpy(D_called).to(dev)
        else:
            D = torch.randint(0, 3, what, dtype=torch.int8, device=dev, generator=gen)
        n, p = D.shape
        label = f"{n}x{p}" + (f" ({what})" if isinstance(what, str) else "")
        K = gram_tri_int8(D, 2)
        R = gram_tri_int8_plain(D, 2)
        torch.cuda.synchronize()
        M = K + torch.tril(K, -1).T
        equal = torch.equal(K, R)
        upper0 = int(torch.triu(K, 1).abs().max()) == 0
        sym = torch.equal(M, M.T)
        err = int((K - R).abs().max())
        print(f"K1 {label}: equal={equal} strict_upper_zero={upper0} "
              f"mirrored_symmetric={sym} max_abs_err={err}")
        check(equal and upper0 and sym, f"K1 at {label}")
        if (n, p) == (N_HEAD, P_HEAD):
            ms = cuda_ms(lambda: gram_tri_int8(D, 2), reps=5)
            plain_ms = cuda_ms(lambda: gram_tri_int8_plain(D, 2), reps=2)
            lib_ms = cuda_ms(lambda: torch._int_mm(D, D.t()), reps=3)
            bound_ms, bound_by = gram_bound(n, p, "int8", 1)
            print(f"K1 {n}x{p}: {ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}; "
                  f"{bound_ms / ms:.1%} of bound) vs plain {plain_ms:.3f} ms, "
                  f"torch._int_mm {lib_ms:.3f} ms {card}")
            records["gram_tri_int8"] = dict(
                max_abs_err=float(err), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms, library="torch._int_mm(D, D.t())")
        del D, K, R, M
    torch.cuda.empty_cache()

    # -- 4. K2 against its plain version --------------------------------------
    try:  # the bf16 yardstick: an f32 output where this torch's mm takes out_dtype
        torch.mm(torch.ones(8, 8, device=dev, dtype=torch.bfloat16),
                 torch.ones(8, 8, device=dev, dtype=torch.bfloat16), out_dtype=torch.float32)
        bf16_lib = "torch.mm(X, X.T, out_dtype=torch.float32)"

        def mm_bf16(X):
            return torch.mm(X, X.T, out_dtype=torch.float32)
    except (TypeError, RuntimeError):
        bf16_lib = "torch.mm(X, X.T) in bf16 (its output is rounded to bf16: no out_dtype here)"

        def mm_bf16(X):
            return torch.mm(X, X.T)
    k2_shapes = []
    k2_inputs = [(129, 257), (256, 2048), (2048, 32768), (n_train, 16_384),
                 "gblup continuous panel"]
    for what in k2_inputs:
        # gblup hands K2 its continuous panel in float32 only
        for dt in (torch.float32,) if isinstance(what, str) else (torch.float32, torch.bfloat16):
            if isinstance(what, str):
                X = torch.from_numpy(X_cont).to(dev)
            else:
                X = torch.rand(what, device=dev, generator=gen).to(dt)
            n, p = X.shape
            label = f"{n}x{p} {str(dt)[6:]}" + (f" ({what})" if isinstance(what, str) else "")
            K = gram_tri_float(X)
            R = gram_tri_float_plain(X)
            torch.cuda.synchronize()
            err = float((K - R).abs().max())
            scale = float(R.abs().max())
            upper0 = float(torch.triu(K, 1).abs().max()) == 0.0
            print(f"K2 {label}: max_abs_err={err:.4g} max|G|={scale:.4g} "
                  f"rel={err / scale:.3g} strict_upper_zero={upper0}")
            check(err <= K2_TOL * scale and upper0, f"K2 at {label}")
            if not isinstance(what, str) and what in ((n_train, 16_384), (2048, 32768)):
                f32 = dt == torch.float32
                ms = cuda_ms(lambda: gram_tri_float(X), reps=10)
                plain_ms = cuda_ms(lambda: gram_tri_float_plain(X), reps=5)
                lib_ms = cuda_ms((lambda: torch.mm(X, X.T)) if f32 else (lambda: mm_bf16(X)), reps=10)
                # f32 runs as three TF32 products on the tensor cores; the same
                # product as FFMA (torch.mm's route, TF32 off) is bounded at 67 TFLOP/s.
                bound_ms, bound_by = (gram_bound(n, p, "tf32", 4, products=3) if f32
                                      else gram_bound(n, p, "bf16", 2))
                rec = dict(shape=f"{n}x{p}", dtype=str(dt)[6:], max_abs_err=err, ms=ms,
                           plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                           library_ms=lib_ms,
                           library="torch.mm(X, X.T), TF32 off" if f32 else bf16_lib)
                if f32:
                    rec["ffma_bound_ms"] = gram_bound(n, p, "f32", 4)[0]
                k2_shapes.append(rec)
                ffma = f", FFMA bound {rec['ffma_bound_ms']:.3f} ms" if f32 else ""
                print(f"K2 {n}x{p} {str(dt)[6:]}: {ms:.3f} ms, bound {bound_ms:.3f} ms "
                      f"({bound_by}; {bound_ms / ms:.1%} of bound{ffma}) vs plain (float64) "
                      f"{plain_ms:.3f} ms, {rec['library']} {lib_ms:.3f} ms {card}")
                if (n, p) == (n_train, 16_384) and f32:  # the shape gblup hands K2
                    records["gram_tri_float"] = {k: v for k, v in rec.items()
                                                 if k not in ("shape", "dtype")}
            del X, K, R
    torch.cuda.empty_cache()

    # -- K3 against its plain version -------------------------------------------
    k3_errs = []
    # The chain reads a 24 MB panel block between two K3 launches, so K3 finds
    # its Cb cold in L2: time it after overwriting a buffer larger than L2
    # (50 MB), less the time of that overwrite, and warm for comparison.
    flush = torch.empty(2**24, device=dev)  # 64 MB
    flush_ms = cuda_ms(flush.zero_, reps=50)
    for bs, K, n_invalid in ((600, 6, 0), (600, 8, 0), (258, 6, 5), (1024, 8, 0), (8192, 8, 7)):
        args = k3_inputs(dev, gen, bs, K, n_invalid=n_invalid)
        label = f"bs={bs} K={K}" + (f" last {n_invalid} invalid" if n_invalid else "")
        k3_errs.append(k3_check(args, K, label))
        if bs == 600:
            warm_ms = cuda_ms(lambda: grouped_block_update(*args, K=K), reps=50)
            ms = cuda_ms(lambda: (flush.zero_(), grouped_block_update(*args, K=K)),
                         reps=50) - flush_ms
            plain_ms = cuda_ms(lambda: (flush.zero_(), grouped_block_update_plain(*args, K=K)),
                               reps=5) - flush_ms
            G = bs // K
            print(f"K3 bs={bs} K={K}: {ms:.4f} ms per block, cold L2 ({ms / G * 1e3:.3f} us per group); "
                  f"warm L2 {warm_ms:.4f} ms ({warm_ms / G * 1e3:.3f} us per group) "
                  f"vs plain {plain_ms:.4f} ms {card}")
            if K == 6:  # the main path's K
                # Bytes: every input read once (Cb dominates, bs²·4), the outputs
                # (d, b_new, incl) written once. Operations: per group and
                # pattern a K×K Cholesky and two triangular solves, ~K³/3 + 2K².
                nbytes = sum(a.numel() * a.element_size() for a in args) + 3 * bs * 4
                bound_ms, bound_by = bound((bs // K) * 2**K * (K**3 / 3 + 2 * K * K),
                                           PEAK["f32"], nbytes)
                records["gibbs_group"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                              bound_by=bound_by, library_ms=None, library="none",
                                              warm_ms=warm_ms, us_per_group=ms / G * 1e3)
                print(f"K3 bs={bs} K={K}: bound {bound_ms * 1e3:.3f} us ({bound_by})")
    del flush

    # -- main path: counters from zero ----------------------------------------
    gbm.reset_launches()

    # -- 5. headline step ------------------------------------------------------
    n, p = N_HEAD, P_HEAD
    D = torch.randint(0, 3, (n, p), dtype=torch.int8, device=dev, generator=gen)
    y = torch.randn(n, device=dev, generator=gen)

    def step():
        return gblup_solve_lower(gram_dosage_lower(D, ploidy=2, device=dev), y, LAM)

    def plain_step():
        L = gram_tri_int8_plain(D, 2).to(torch.float32) / 4.0
        return gblup_solve_lower(_center_gram_lower(L), y, LAM)

    torch.cuda.reset_peak_memory_stats()
    gebv = step()
    gebv_plain = plain_step()
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(gebv).all())
    rel = float((gebv - gebv_plain).abs().max() / gebv_plain.abs().max())
    print(f"headline {n}x{p}: gebv finite={finite} shape={tuple(gebv.shape)} "
          f"max|Δ|/max|plain|={rel:.3g} peak_mem={torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(finite and gebv.shape == (n,) and rel <= GEBV_TOL, "headline GEBV vs plain path")
    t = wall_median_s(step, reps=5)
    t_plain = wall_median_s(plain_step, reps=3)
    print(f"headline GRM+GBLUP {n}x{p} int8 (K1 + cholesky, lam={LAM:g}): median {t * 1e3:.3f} ms, "
          f"{n * p / t:.4g} SNPs/s; plain path {t_plain * 1e3:.3f} ms, "
          f"{n * p / t_plain:.4g} SNPs/s {card}")
    del D, y, gebv, gebv_plain
    torch.cuda.empty_cache()

    # -- 6. public API -----------------------------------------------------------
    y_test = phenomes.phenotypes[test, 0]
    cor_test = {}
    for label, g, kernel in (("continuous", genomes, "gram_tri_float"),
                             ("called", called, "gram_tri_int8")):
        before = gbm.LAUNCHES[kernel]
        t0 = time.perf_counter()
        fit = gbm.gblup(g, phenomes, idx_entries=train, device=dev)
        pred = gbm.predict(fit, g, test, device=dev)
        t_fit = time.perf_counter() - t0
        t0 = time.perf_counter()
        fit_cpu = gbm.gblup(g, phenomes, idx_entries=train, device="cpu")
        pred_cpu = gbm.predict(fit_cpu, g, test, device="cpu")
        t_cpu = time.perf_counter() - t0
        cor_fit = float(np.corrcoef(fit.y_pred, fit_cpu.y_pred)[0, 1])
        cor_pred = float(np.corrcoef(pred, pred_cpu)[0, 1])
        cor_test[label] = float(np.corrcoef(pred, y_test)[0, 1])
        ex = fit.extras
        print(f"gblup {label}: sigma2_e={ex['sigma2_e']:.6g} sigma2_u={ex['sigma2_u']:.6g} "
              f"h2={ex['h2']:.6g} (cpu: {fit_cpu.extras['sigma2_e']:.6g} "
              f"{fit_cpu.extras['sigma2_u']:.6g} {fit_cpu.extras['h2']:.6g})")
        print(f"gblup {label}: cor(y_pred, cpu)={cor_fit:.8f} cor(predict, cpu)={cor_pred:.8f} "
              f"cor(predict, y_test)={cor_test[label]:.4f}")
        stages = " ".join(f"{k}={v * 1e3:.1f}ms" for k, v in ex["stage_seconds"].items())
        print(f"gblup {label}: fit+predict {t_fit:.3f} s on the card ({stages}); "
              f"device='cpu' {t_cpu:.3f} s {card}")
        check(bool(np.all(np.isfinite(fit.y_pred))) and bool(np.all(np.isfinite(pred))),
              f"gblup {label} finite")
        check(cor_fit >= COR_MIN and cor_pred >= COR_MIN, f"gblup {label} vs plain path")
        check(gbm.LAUNCHES[kernel] > before, f"gblup {label} launched {kernel}")

    # -- 7. Bayesian alphabet at size (BASELINE config 3) --------------------------
    n, p = N_BIG, P_BIG
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    X = torch.randint(0, 3, (n, p), dtype=torch.int8, device=dev, generator=gen)
    X = X.to(torch.float32).mul_(0.5)  # dosages / 2, as bench.py
    beta = torch.randn(p, device=dev, generator=gen)
    beta *= torch.rand(p, device=dev, generator=gen) < 0.01  # 1 % causal
    g_true = X @ beta
    y = g_true + torch.randn(n, device=dev, generator=gen) * g_true.std()  # h2 ~ 0.5
    torch.cuda.synchronize()
    print(f"BayesC panel {n}x{p} f32 on the card ({X.numel() * 4 / 1e9:.2f} GB, "
          f"{int((beta != 0).sum())} causal): {time.perf_counter() - t0:.2f} s")
    # The chain's first call of K3, kept for the comparison after the main path.
    first_block = []
    # (the models package exports the function `bayesian` under the module's name)
    bayes_mod = importlib.import_module("genomicbreedingmodels_tpu_torch.models.bayesian")
    kernel_step = bayes_mod._block_kernel

    def keep_first(*args):
        if not first_block:
            first_block.extend(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
        return kernel_step(*args)

    launches_per_call = SWEEPS_BIG * (p // BS_BIG)
    bayes_mod._block_kernel = keep_first
    try:
        times = {}
        for call in ("first", "warm"):
            before = gbm.LAUNCHES["gibbs_group"]
            t0 = time.perf_counter()
            mu, b_hat, diag = gbm.gibbs_regression(
                X, y, model="BayesC", block_size=BS_BIG, n_iter=SWEEPS_BIG, n_burnin=BURN_BIG,
                device=dev)
            times[call] = time.perf_counter() - t0
            launched = gbm.LAUNCHES["gibbs_group"] - before
            st = diag["stage_seconds"]
            print(f"BayesC {n}x{p} bs={BS_BIG} {SWEEPS_BIG} sweeps, {call} call: "
                  f"{times[call]:.3f} s (prep {st['prep']:.3f} s: copy, centering, block Grams; "
                  f"sweeps {st['sweeps']:.3f} s) path={diag['update']} K3 launches={launched}")
            check(diag["update"] == "pallas" and launched == launches_per_call,
                  f"BayesC at size launched K3 {launches_per_call} times")
    finally:
        bayes_mod._block_kernel = kernel_step
    bt = torch.from_numpy(b_hat).to(dev, torch.float32)
    cor_big = float(torch.corrcoef(torch.stack([X @ bt, g_true]))[0, 1])
    sig_tr = diag["sigma_e2_trace"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"BayesC {n}x{p}: cor(X b_hat, g_true)={cor_big:.4f} "
          f"sigma_e2 posterior mean={sig_tr[BURN_BIG:].mean():.6g} (var y={float(y.var()):.6g}) "
          f"mu={mu:.6g}")
    print(f"BayesC {n}x{p}: {SWEEPS_BIG * p / times['warm']:.6g} marker-updates/s (warm call), "
          f"first call {times['first']:.3f} s, peak memory {peak:.2f} GiB {card}")
    check(bool(np.all(np.isfinite(b_hat))) and bool(np.all(np.isfinite(sig_tr)))
          and np.isfinite(mu), "BayesC at size finite")
    check(cor_big >= 0.5, "BayesC at size: cor(X b_hat, g_true) >= 0.5")
    del beta, g_true, bt  # X and y stay for the profiler pass, the script's last phase
    torch.cuda.empty_cache()

    # -- 8. K3 and the plain grouped draw agree along the chain ---------------------
    rng_e = np.random.default_rng(7)  # the bench's ESS panel (bench.py:333-337)
    X_e = (rng_e.integers(0, 3, size=(512, 4096)) / 2.0).astype(np.float32)
    beta_e = (rng_e.normal(size=4096) * (rng_e.uniform(size=4096) < 0.01)).astype(np.float32)
    g_e = X_e @ beta_e
    y_e = (g_e + rng_e.normal(size=512) * max(g_e.std(), 1e-3)).astype(np.float32)
    chains = {}
    for upd in ("auto", "grouped"):
        t0 = time.perf_counter()
        mu, b_e, diag = gbm.gibbs_regression(X_e, y_e, model="BayesC", n_iter=400, n_burnin=100,
                                             seed=2, indicator_update=upd, device=dev)
        t = time.perf_counter() - t0
        s2_mean = float(diag["sigma_e2_trace"][100:].mean())
        chains[upd] = (mu + X_e @ b_e, s2_mean)
        print(f"BayesC 512x4096 400 sweeps, indicator_update={upd!r} -> {diag['update']}: {t:.3f} s, "
              f"effect ESS {diag['ess_effects_mean']:.1f}, sigma_e2 ESS {diag['ess_sigma_e2']:.1f}, "
              f"sigma_e2 posterior mean {s2_mean:.6g}, cor(X b, g)={np.corrcoef(X_e @ b_e, g_e)[0, 1]:.4f} "
              f"{card}")
        check(diag["update"] == ("pallas" if upd == "auto" else "grouped-hoisted"),
              f"indicator_update={upd!r} path")
    cor_chains = float(np.corrcoef(chains["auto"][0], chains["grouped"][0])[0, 1])
    s2_rel = abs(chains["auto"][1] - chains["grouped"][1]) / chains["grouped"][1]
    print(f"BayesC 512x4096 K3 vs grouped: GEBV cor={cor_chains:.4f} sigma_e2 rel diff={s2_rel:.4f}")
    check(cor_chains >= 0.98 and s2_rel <= 0.25, "K3 and grouped chains agree")

    # -- 9. public API: bayesc and bayesian_ridge -> predict ------------------------
    for fn, path in ((gbm.bayesc, "pallas"), (gbm.bayesian_ridge, "joint-hoisted")):
        before = gbm.LAUNCHES["gibbs_group"]
        t0 = time.perf_counter()
        fit = fn(genomes, phenomes, idx_entries=train, n_iter=300, n_burnin=100, device=dev)
        pred = gbm.predict(fit, genomes, test, device=dev)
        t = time.perf_counter() - t0
        launched = gbm.LAUNCHES["gibbs_group"] - before
        cor = float(np.corrcoef(pred, y_test)[0, 1])
        print(f"{fn.__name__}: path={fit.extras['update']} K3 launches={launched} "
              f"cor(predict, y_test)={cor:.4f} (gblup continuous {cor_test['continuous']:.4f}); "
              f"fit+predict {t:.3f} s {card}")
        check(bool(np.all(np.isfinite(fit.b_hat))) and bool(np.all(np.isfinite(pred))),
              f"{fn.__name__} finite")
        check(fit.extras["update"] == path and (launched > 0) == (path == "pallas"),
              f"{fn.__name__} ran {path}")

    launches = dict(gbm.LAUNCHES)
    print(f"launches on the main path: {launches}")
    for name, count in launches.items():
        check(count > 0, f"{name} launched on the main path")

    # K3 on the first block of phase 7's chain, with its real Cb, u, s2, sigma_e2
    # and noise (after the counters were read: these launches do not count).
    k3_errs.append(k3_check(first_block[:9], first_block[9], "at-size chain, first block"))
    records["gibbs_group"]["max_abs_err"] = max(k3_errs)

    # -- 10. cross-validation, counters from zero -----------------------------------
    t0 = time.perf_counter()
    cv_launches = cv_phase(gbm, dev, card)
    print(f"phase 10: {time.perf_counter() - t0:.1f} s; launches in phase 10: {cv_launches}")
    for name, count in cv_launches.items():
        check(count > 0, f"{name} launched in phase 10")

    # Phase 7's question, asked last: does the device or the host set the
    # pace at size? The same short call without and then under the profiler.
    # The profiler slows the host, so the device time is also set against
    # the unprofiled call's wall. It runs after every timed phase because,
    # once the profiler had traced the card, later host-bound chains in the
    # same process ran 30-70 % slower, kernel-free ones too.
    def short_call():
        gbm.gibbs_regression(X, y, model="BayesC", block_size=BS_BIG, n_iter=5, n_burnin=1,
                             device=dev)

    plain_wall = wall_median_s(short_call, reps=1)
    wall, busy, k3, top = profile_call(short_call, "gibbs_group")
    if busy > 0:
        print(f"BayesC {N_BIG}x{P_BIG} 5 sweeps under torch.profiler (one call, prep included): "
              f"wall {wall * 1e3:.1f} ms, device kernel time {busy * 1e3:.1f} ms (busy share "
              f"{busy / wall:.1%}), K3 {k3 * 1e3:.1f} ms ({k3 / busy:.1%} of device time); the "
              f"same call without the profiler {plain_wall * 1e3:.1f} ms (device time over it "
              f"{busy / plain_wall:.1%}) {card}")
        print("  most device time: " + "; ".join(f"{t * 1e3:.1f} ms {name[:70]}" for t, name in top))
    else:
        print("BayesC under torch.profiler: the trace holds no device time (not measured)")
    del X, y

    sources = {
        # K1 and K2 are one mainloop in the header, instantiated by gram_tri_int8.cu
        # and gram_tri_float.cu.
        "gram_tri_int8": ("genomicbreedingmodels_tpu_torch/csrc/gram_tri_sm90.cuh",
                          "genomicbreedingmodels_tpu/ops/pallas_kernels.py:138"),
        "gram_tri_float": ("genomicbreedingmodels_tpu_torch/csrc/gram_tri_sm90.cuh",
                           "genomicbreedingmodels_tpu/ops/pallas_kernels.py:55"),
        "gibbs_group": ("genomicbreedingmodels_tpu_torch/csrc/gibbs_group.cu",
                        "genomicbreedingmodels_tpu/ops/pallas_gibbs.py:63"),
    }
    records["gram_tri_float"]["shapes"] = k2_shapes
    kernels = [  # launches: phases 5-9 and phase 10, each counted from zero
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name] + cv_launches[name], **records[name]}
        for name, (src, rep) in sources.items()
    ]
    print(f"chip_smoke.py: {time.perf_counter() - t_main:.1f} s from the first check to here {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
