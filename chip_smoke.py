#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Usage, from the root of a checkout:  python3 chip_smoke.py

1. environment: torch / CUDA versions, the card's name and power limit,
   nvcc, whether triton imports;
2. builds the port's kernels from `genomicbreedingmodels_tpu_torch/csrc`,
   prints each kernel's registers and spills from ptxas and, where cuobjdump
   exists, its count of wgmma (IGMMA / HGMMA) and TMA (UTMALDG) instructions;
3. K1 (`gram_tri_int8`) against its plain version: bit-equal, strict upper
   triangle zero, exactly symmetric once mirrored; on random dosages (one
   shape with two groups of the tile order and marker splits) and on the
   called panel's own training dosages that phase 6's `gblup` uses;
   timed at 8192x262144 beside its bound and `torch._int_mm(D, D.t())`;
4. K2 (`gram_tri_float`, f32 and bf16) against its plain version (a float64
   product): max |err| <= 1e-5 · max|G|; on random panels and on phase 6's
   continuous training panel; timed at 1844x16384 and 2048x32768 beside its
   bound and `torch.mm(X, X.T)` (TF32 off; bf16 with an f32 output where
   this torch's mm takes `out_dtype`);
5. the headline step at n=8192, p=262144 int8: `gram_dosage_lower` (K1) then
   `gblup_solve_lower`, checked against the plain-version path on the card
   and timed against it; the step split into its stages (K1, the int32 ->
   f32 epilogue, the centering, the mirror and diagonal add, `cholesky_ex`,
   `cholesky_solve`), each timed alone beside its bound, their sum against
   the step's wall median; the blocked solver of the JAX package
   (`gblup_solve_lower(nb=)` at nb = 8, 16, 32) on the same centered
   triangle against the cuSOLVER path, and `blocked_cholesky`'s factor
   against `torch.linalg.cholesky`;
   (K3) K3 (`grouped_block_update`, the grouped Gibbs block update) against
   its plain version on the same inputs and noise: identical selections,
   draws within K3_TOL; at bs=600 with K=6 and K=8, at bs=258 with K=6 and the
   last 5 markers invalid, at bs=1024 with K=8 (the largest "auto" block,
   every Cb row staged in shared memory) and at bs=8192 with K=8 and the last
   7 markers invalid (the rows staged in part, the rest read from L2); timed
   per block and per group at bs=600, K=6 and K=8, with Cb cold in L2, as
   the chain finds it, and warm; the fold-batched launch at bs=258, K=6 for
   15 folds against 15 single launches (bit-equal) and the plain version,
   timed with Cb cold beside 15 single launches;
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
   200 sweeps (cut from 400 to hold the script's time) through K3 ("auto") and through the plain grouped draw on the
   card ("grouped"): GEBV correlation >= 0.98, sigma_e2 posterior means within
   25 %;
9. the public API again: `bayesc` (K3) and `bayesian_ridge` (joint block
   draw, no kernel) on phase 6's panel -> `predict`;
10. cross-validation (`cv_phase`): `cvbulk_batched` and `cvbulk` on the card
   against device="cpu" at 256x2048, the JAX bench's `cv` cell at 2048x32768
   cold and warm, `cvbulk` over six models at that width (K2 and K3 launched
   by the jobs) and again with two workers, and `validate`'s leakage check;
11. GWAS (`gwas_phase`): gwasols, gwaslmm and gwasreml on the card against
   device="cpu" on a 256x2048 QTL panel; the JAX bench's `gwas` cell at
   2048x32768 (gwasreml cold and warm, gwasols and gwaslmm on the cached
   prep, markers/s, stage split, peak memory) with the upload measurement
   (f32 against uint8 codes); cuSOLVER's eigh of phase 7's 10,000-entry GRM
   in f32 and f64;
12. multi-trait (`multitrait_phase`): four correlated traits on phase 7's
   10,000 x 102,000 panel, 10 % of the noisy trait missing:
   `gblup_multitrait_cov` at size (stages, genetic correlations against the
   simulated ones, the noisy trait against its single-trait `gblup`),
   `gblup_multitrait` on the complete traits, the card against device="cpu"
   on a 512x4096 cut, and `gblup_multienv` on a 3-year x 2-site trial set on
   phase 6's panel, card against device="cpu" and against an all-f64 fit;
13. fold-batched Bayesian CV (`fold_phase`): pinned-variance BRR fold chains
   against each fold's closed form and `cvbulk_batched` bayesc on the card
   against device="cpu" at 256x2048 (1x3 folds), the chain's first
   fold-batched K3 call against its single launches and the plain version;
   the cv cell at 2048x32768, 3x5 folds, over bayesc, bayesian_ridge and
   bayesian_lasso at 200 sweeps, one cold call (K3 once per block and sweep
   for all 15 folds), beside phase 10 (c)'s `cvbulk` bayesc per fold;
14. epistasis (`epistasis_phase`): `transform2` (mult, addnorm, raise_) on
   the card against device="cpu" at 256x2048; the JAX bench's `epistasis`
   cell (512x16384, k=1000, mult and addnorm, cold and warm, pairs/s);
   `epistasisfeatures` (n_reps=1) at 512x2048 and its round-trip;
15. out-of-core and the command line (`outofcore_phase`): .bed round trips,
   `grm_from_bed` (K1 for complete shards, K2 for imputed ones) and the
   card's `unpack_bed_payload` against the host at 512x4096; the JAX bench's
   `diskstream` cell (25,000 x 250,000 .bed streamed in 8 shards: pieces CG
   and dense K1 + Cholesky) and `northstar` cell (50,000 x 500,000 as 8
   int8 shards made on the card: pieces CG and dense K1 + Cholesky), SNPs/s
   with stages and peak memory; `python -m genomicbreedingmodels_tpu_torch`
   fit/predict/grm in-process on phase 6's called panel;
16. the mesh paths (`mesh_phase`), two ranks as threads on this one card
   over gloo (`parallel/mesh.py:run_ranks`; NCCL refuses two ranks on one
   device, and gloo stages each collective through the host, so the times
   are not interconnect times): `sharded_grm` int8 on phase 7's panel (K1
   per rank) bit-equal to the single-device GRM, also over a one-rank NCCL
   group, and f32 at 2048x32768 (K2); the marker-sharded BayesC chain on
   phase 7's panel (K3 per rank) against phase 7's chain; `sharded_gblup_cg`
   on phase 7's panel against a float64 dense solve; `cvbulk_batched(mesh=)`
   (ridge, gblup, bayesc) against phases 10 and 13, the three GWAS scans
   against phase 11, `transform2(mesh=)` against mesh=None; the
   `dryrun_multichip` twin at 2 and 4 ranks; the parity ledger on the card;
   the weak-scaling harness (`scripts/torch_weak_scaling.py`) at D = 1, 2;
17. the Gram schedules (`gram_phase`): `gram_recursive`, `gram_triangular`,
   `gram_centered_blocked` and `gram_centered_device` (K2 in both its modes)
   against `gram_panel` (K2) at the bench's 2048x32768 cell in f32 and bf16,
   each timed;
18. the repaired GRM routes and the examples (`examples_phase`): (a)
   `gram_auto` of phase 6's called panel as an int8 tensor (K1, bit-equal to
   `gram_dosage`) and `gram_centered_device`'s default at 2048x32768 f32 and
   bf16 (K2, against `gram_panel`, timed beside the library product it ran
   before); (b) `examples/torch_quickstart.py`, `torch_gwas_workflow.py`,
   `torch_out_of_core.py` and `torch_multichip_sharding.py` through their
   `main(device="cuda")` at their own sizes, each against `main(device="cpu")`
   (held-out cor, CV folds, the gwasols top 20, GEBVs, the sharded GRMs
   against the single-device `gram_auto`), with the kernels each launched.
19. the port's bench (`bench_phase`): `bench_torch.py --section headline`
   (its one line within 10 % of phase 5's SNPs/s, its check passed, K1
   launched in the child), `--section linkprobe` (one or two lines) and
   `main()` with GBM_BENCH_HEADLINE_ONLY=1 (the last stdout line the
   headline's), each in a subprocess whose launches its own notes count.

Launch counters are reset after the comparisons of phases 3-4 and K3 and read
after phase 9; every kernel must have launched on that main path. Then K3 is
held against its plain version once more, on the first block of phase 7's
chain as the chain called it. Phase 10 runs with the counters reset again
and read after it, and every kernel must have launched there too; so do
phases 11 (K2 must launch), 12 (K1 or K2 must launch), 13 (K2 and K3 must
launch), 14 (no hand kernel on its path), 15 (K1 and K2 must launch), 16
(K1, K2 and K3 must launch), 17 (K2 must launch) and 18 (K1, K2 and K3 must
launch); phase 19's children count theirs (K1 must launch).
After each of phases 5-9 and 10 to 18 is read, K1 and K2
are held against their plain versions at every operand shape, and K3 at
every (folds, bs, K), the phase launched them at that no earlier check held (`hold_launched_shapes`). Then phase 7's
panel goes through the profiler.
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
# Phase 10 (c)'s chains, cut from the config's 1500 sweeps to hold the
# script's time.
CV_C_SWEEPS, CV_C_BURN = 100, 25
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


def load_script(name: str, folder: str = "scripts"):
    """The module <folder>/<name>.py of this checkout."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, Path(__file__).resolve().parent / folder
                                                  / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
    zero_invalid = not bool(b[..., invalid].any() or incl[..., invalid].any())
    finite = bool(torch.isfinite(b).all() and torch.isfinite(d).all())
    print(f"K3 {label}: incl_identical={same} included={int(incl.sum())}/{b.numel()} "
          f"max_abs_err={err:.3g} (tol {tol:.3g}) invalid_zero={zero_invalid} finite={finite}")
    check(same and err <= tol and zero_invalid and finite, f"K3 at {label}")
    return err


def k3_fold_inputs(dev, gen, F: int, bs: int, K: int, n_invalid: int = 0) -> list:
    """F blocks as the fold chain hands them to K3, stacked on a fold axis:
    each fold's Cb, u, effects and noise from its own panel, σ²ₑ and π per
    fold, the validity mask shared."""
    import torch

    blocks = [k3_inputs(dev, gen, bs, K, n_invalid=n_invalid) for _ in range(F)]
    args = [torch.stack([blk[i] for blk in blocks]) for i in range(9)]
    args[4] = blocks[0][4]
    args[7] = args[7] * torch.linspace(0.7, 1.3, F, device=dev)
    args[8] = args[8] * torch.linspace(0.5, 2.0, F, device=dev)
    return args


def k3_fold_check(args: list, K: int, label: str) -> float:
    """The fold-batched K3 call against F single launches (bit-equal) and
    against the plain version on the same inputs (identical selections,
    draws within K3_TOL); returns max |err| against the plain version."""
    import torch

    from genomicbreedingmodels_tpu_torch.kernels.gibbs_group import (
        grouped_block_update,
        grouped_block_update_plain,
    )

    F = args[0].shape[0]
    out = grouped_block_update(*args, K=K)
    singles = [grouped_block_update(*(a if i == 4 else a[f].contiguous() for i, a in enumerate(args)),
                                    K=K) for f in range(F)]
    ref = grouped_block_update_plain(*args, K=K)
    torch.cuda.synchronize()
    bitequal = all(torch.equal(x[f], r) for f in range(F) for x, r in zip(out, singles[f]))
    same = torch.equal(out[2], ref[2])
    err = max(float((out[1] - ref[1]).abs().max()), float((out[0] - ref[0]).abs().max()))
    tol = K3_TOL * max(1.0, float(ref[1].abs().max()))
    finite = bool(torch.isfinite(out[1]).all())
    print(f"K3 fold-batched {label}: equal to {F} single launches={bitequal} incl_identical={same} "
          f"included={int(out[2].sum())}/{out[2].numel()} max_abs_err={err:.3g} (tol {tol:.3g}) "
          f"finite={finite}")
    check(bitequal and same and err <= tol and finite, f"fold-batched K3 at {label}")
    return err


def keys(cvs):
    return [(cv.fit.trait, cv.fit.model, cv.replication, cv.fold) for cv in cvs]


def run_checked(dev, fn, *args, **kw):
    """fn(*args, **kw) with its warnings recorded and its wall seconds (the
    call ends in read-backs); fails on a model-fitting or CV warning."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter() - t0
    msgs = [str(w.message) for w in rec]
    for m in msgs:
        print(f"  warning: {m[:200]}")
    bad = [m for m in msgs if "model-fitting error" in m or "cross-validation error" in m]
    check(not bad, f"{getattr(fn, '__name__', fn)}: no model-fitting warning")
    return out, t


def cv_cell(gbm, n: int, p: int):
    """The JAX bench's `cv` cell (bench.py:610-659): an n x p uniform panel
    from rng(11), 1 % causal, h2 ~ 0.5; (Genomes, Phenomes)."""
    import numpy as np

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
    return G, P


def cv_phase(gbm, dev, card: str, width=(2048, 32_768)) -> tuple:
    """Phase 10, cross-validation on the card, with the launch counters set
    to 0 just before it; returns the counts it launched, part (c)'s wall
    seconds per model and part (b)'s warm CVs (phase 16 holds the mesh
    dispatch to them). `width` is (n, p)
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
    ridge, lasso, gblup, bayesc, mlp; chains cut to CV_C_SWEEPS sweeps,
    CV_C_BURN burn-in):
    30 CVs, no model-fitting warning, K2 and K3 launched by these calls;
    then ridge and bayesc again with n_workers=2, each y_pred within
    WORKERS_TOL·max|y_pred| of the n_workers=1 run;
    (d) `validate` raises on a train/validation overlap.
    """
    import dataclasses

    import numpy as np
    import torch

    from genomicbreedingmodels_tpu_torch.cv import batched as cv_batched
    from genomicbreedingmodels_tpu_torch.utils import config

    def run(fn, *args, **kw):
        return run_checked(dev, fn, *args, **kw)

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
    G, P = cv_cell(gbm, n, p)
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
    cell_cvs = cvs
    cors = {m: float(np.mean([cv.metrics["cor"] for cv in cvs if cv.fit.model == m])) for m in models}
    print("CV (b) mean validation cor: " + " ".join(f"{m}={c:.4f}" for m, c in cors.items())
          + f"; K2 launches {gbm.LAUNCHES['gram_tri_float'] - before['gram_tri_float']}")

    # -- (c) the executor at the same width ---------------------------------------------
    cfg = config.get_config()
    config.set_config(dataclasses.replace(cfg, mcmc_n_iter=CV_C_SWEEPS, mcmc_n_burnin=CV_C_BURN))
    try:
        before = dict(gbm.LAUNCHES)
        one, seconds = {}, {}
        for m in ("ols", "ridge", "lasso", "gblup", "bayesc", "mlp"):
            k0 = dict(gbm.LAUNCHES)
            (cvs, _), t = run(gbm.cvbulk, G, P, models=[m], n_replications=1, n_folds=5, seed=3,
                              n_workers=1, device=dev)
            one[m], seconds[m] = cvs, t
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

    return dict(gbm.LAUNCHES), seconds, cell_cvs


def upload_line(freq, card: str) -> None:
    """The measurement behind `_prep_device`'s f32 upload: at the bench
    panel's size, the JAX prep's host quantisation to uint8 q = 240·G (its
    numpy fallback, genomicbreedingmodels_tpu/models/gwas.py:286-295), and
    the pageable h2d of the f32 panel and of the uint8 codes; then the
    port's own upload (f64 numpy to an f32 card tensor, as `_prep_device`)."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    G32 = np.asarray(freq, dtype=np.float32)
    q = np.rint(G32 * np.float32(240.0))
    on_grid = (float(np.max(np.abs(G32 - q * np.float32(1.0 / 240.0)))) <= 2e-7
               and float(q.max(initial=0.0)) <= 255.0 and float(q.min(initial=0.0)) >= 0.0)
    codes = q.astype(np.uint8)
    t_quant = time.perf_counter() - t0
    check(on_grid, "the gwas cell's panel lies on the q/240 grid")
    times = {}
    for label, arr in (("f32", G32), ("uint8", codes)):
        host = torch.from_numpy(arr)
        ts = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            host.to("cuda")
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        times[label] = (min(ts), arr.nbytes)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.as_tensor(freq).to(device="cuda", dtype=torch.float32)
    torch.cuda.synchronize()
    t_port = time.perf_counter() - t0
    n, p = freq.shape
    print(f"GWAS upload {n}x{p}: host quantise to uint8 (numpy, as the JAX prep's fallback) "
          f"{t_quant:.3f} s; h2d f32 {times['f32'][1] / 1e6:.0f} MB {times['f32'][0] * 1e3:.1f} ms "
          f"({times['f32'][1] / times['f32'][0] / 1e9:.2f} GB/s), uint8 {times['uint8'][1] / 1e6:.0f} MB "
          f"{times['uint8'][0] * 1e3:.1f} ms ({times['uint8'][1] / times['uint8'][0] / 1e9:.2f} GB/s), "
          f"best of 3, pageable; the port's upload (f64 host panel to f32 on the card) "
          f"{t_port * 1e3:.1f} ms {card}")


def eigh_line(X, card: str) -> None:
    """cuSOLVER's eigh of an n=10,000 GRM in f32 and in f64: times and the f32
    spectrum's distance from f64 over max|K|. The GRM is that of phase 7's
    dosage panel (X = dosages/2 on the card), built by K1."""
    import torch

    from genomicbreedingmodels_tpu_torch.ops.grm import gram_dosage

    mu = X.mean(dim=0)
    denom = float(2.0 * (mu * (1.0 - mu)).sum())
    K = gram_dosage((X * 2.0).to(torch.int8), ploidy=2, device=X.device) / denom
    torch.linalg.eigh(torch.eye(8, device=X.device))  # cuSOLVER's handle, outside the timing
    out = {}
    for dt in (torch.float32, torch.float64):
        Kd = K.to(dt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s, U = torch.linalg.eigh(Kd)
        torch.cuda.synchronize()
        out[dt] = (time.perf_counter() - t0, s)
        del Kd, U
    err = float((out[torch.float32][1].double() - out[torch.float64][1]).abs().max() / K.abs().max())
    print(f"eigh n={K.shape[0]} (GRM of phase 7's panel, K1): cuSOLVER f32 {out[torch.float32][0]:.3f} s, "
          f"f64 {out[torch.float64][0]:.3f} s; f32 spectrum max|Δs|/max|K| = {err:.3g} {card}")
    check(err < 1.0, "eigh n=10000: the f32 spectrum is finite")
    del K, out
    torch.cuda.empty_cache()


def hold_launched_shapes(held: dict, gen, phase: str) -> None:
    """Holds K1 and K2 against their plain versions at every operand shape
    the phase just run launched them at (`_build.LAUNCH_SHAPES`) that no
    earlier check held, on random panels of that shape and type as phases
    3-4 make them (dosages in {0, 1, 2}; uniform [0, 1) in f32 or bf16), and
    K3 at every (folds, bs, K) it launched at (`k3_fold_check` on random
    blocks). Runs after the phase's counts were read: these launches do not
    count. Adds each shape to `held` (kernel -> set of shapes)."""
    import torch

    from genomicbreedingmodels_tpu_torch.kernels import _build
    from genomicbreedingmodels_tpu_torch.kernels.gram_tri import (
        gram_tri_float,
        gram_tri_float_plain,
        gram_tri_int8,
        gram_tri_int8_plain,
    )

    todo = sorted((name, key) for name in ("gram_tri_int8", "gram_tri_float")
                  for key in _build.LAUNCH_SHAPES[name] - held[name])
    k3_todo = sorted(_build.LAUNCH_SHAPES["gibbs_group"] - held["gibbs_group"])
    for F, bs, K in k3_todo:  # K3 at each (folds, bs, K) it launched at
        k3_fold_check(k3_fold_inputs("cuda", gen, F, bs, K, n_invalid=3), K,
                      f"F={F} bs={bs} K={K} as launched in {phase}")
        held["gibbs_group"].add((F, bs, K))
    for name, (dt, n, p) in todo:
        if name == "gram_tri_int8":
            D = torch.randint(0, 3, (n, p), dtype=torch.int8, device="cuda", generator=gen)
            K, R = gram_tri_int8(D, 2), gram_tri_int8_plain(D, 2)
            torch.cuda.synchronize()
            equal, upper0 = torch.equal(K, R), not bool(torch.triu(K, 1).any())
            print(f"K1 {n}x{p} as launched in {phase}: equal={equal} strict_upper_zero={upper0} "
                  f"max_abs_err={int((K - R).abs().max())}")
            check(equal and upper0, f"K1 at {n}x{p}, launched in {phase}")
            del D
        else:
            X = torch.rand((n, p), device="cuda", generator=gen).to(getattr(torch, dt))
            K, R = gram_tri_float(X), gram_tri_float_plain(X)
            torch.cuda.synchronize()
            err, scale = float((K - R).abs().max()), float(R.abs().max())
            upper0 = not bool(torch.triu(K, 1).any())
            print(f"K2 {n}x{p} {dt} as launched in {phase}: max_abs_err={err:.4g} max|G|={scale:.4g} "
                  f"rel={err / scale:.3g} strict_upper_zero={upper0}")
            check(err <= K2_TOL * scale and upper0, f"K2 {dt} at {n}x{p}, launched in {phase}")
            del X
        held[name].add((dt, n, p))
        del K, R
    torch.cuda.empty_cache()
    print(f"{phase}: K1/K2 held against their plain versions at {len(todo)} and K3 at "
          f"{len(k3_todo)} more shape(s) it launched; every launched shape is now held")


# Phase 5's split of the headline step: each stage timed alone by CUDA
# events on the headline's own inputs, beside its bound; the stages' sum is
# held to the step's wall median within HEAD_SPLIT_TOL. The blocked solver of
# the JAX package (`gblup_solve_lower(nb=)`) beside the cuSOLVER path on the
# same centered triangle, held at the headline's λ = 0.1·p only: its explicit
# block inverses lose accuracy as κ(block)², and λ = 0.1 on the raw scale
# leaves K + λI within float32 rounding of singular (ROADMAP C.3). Its factor
# is held to `torch.linalg.cholesky` at CHOL_TOL·max|L| (the JAX test's).
HEAD_SPLIT_TOL = 0.10
BLOCKED_NB = (8, 16, 32)
CHOL_TOL = 5e-4


def headline_split(D, y, wall_ms: float, card: str) -> tuple:
    """The headline step `gblup_solve_lower(gram_dosage_lower(D), y, LAM)`
    cut into its stages (`bench_torch.headline_split`), each timed by CUDA
    events on the output of the one before; returns (the centered lower
    triangle, the GEBVs, {stage: (ms, bound_ms, bound_by)})."""
    bench = load_script("bench_torch", ".")
    Kc, gebv, stages = bench.headline_split(D, y, LAM, lambda fn: cuda_ms(fn, reps=10))
    out = {name: (ms,) + bound(ops, PEAK[peak], nbytes) for name, (ms, ops, peak, nbytes) in stages.items()}
    n, p = D.shape
    total = sum(v[0] for v in out.values())
    for name, (ms, b_ms, by) in out.items():
        print(f"  headline stage {name}: {ms:.3f} ms ({ms / total:.1%} of the sum), bound "
              f"{b_ms:.3f} ms ({by}; {b_ms / ms:.1%} of bound)")
    print(f"headline split {n}x{p}: stages sum {total:.3f} ms against the step's wall median "
          f"{wall_ms:.3f} ms (ratio {total / wall_ms:.3f}); non-K1 stages "
          f"{total - out['K1 (gram_tri_int8)'][0]:.3f} ms {card}")
    check(abs(total / wall_ms - 1.0) <= HEAD_SPLIT_TOL,
          f"the headline's stages sum to within {HEAD_SPLIT_TOL:.0%} of its wall median")
    return Kc, gebv, out


def blocked_solver_lines(Kc, y, gebv, card: str) -> dict:
    """`gblup_solve_lower(Kc, y, LAM, nb=nb)` (the blocked solver) for nb in
    BLOCKED_NB against the cuSOLVER path's GEBVs `gebv` (GEBV_TOL), and
    `blocked_cholesky` against `torch.linalg.cholesky` (CHOL_TOL); the
    median of 5 wall times of each solve and the CUDA-event time of each
    factor, beside the cuSOLVER path's."""
    import torch

    from genomicbreedingmodels_tpu_torch.ops.chol import blocked_cholesky, gblup_solve_lower

    n = Kc.shape[0]
    A = Kc.clone()  # the lower triangle is read; the upper keeps the centering's values
    A.diagonal().add_(LAM)
    Am = torch.tril(A) + torch.tril(A, -1).T
    L_ref = torch.linalg.cholesky(Am)
    scale = float(L_ref.abs().max())
    out = {"cusolver": dict(solve_ms=wall_median_s(lambda: gblup_solve_lower(Kc, y, LAM), 5) * 1e3,
                            factor_ms=cuda_ms(lambda: torch.linalg.cholesky_ex(Am), reps=5))}
    print(f"solver n={n}, lam={LAM:g}: cuSOLVER (nb=None, the default) solve median "
          f"{out['cusolver']['solve_ms']:.3f} ms, cholesky_ex {out['cusolver']['factor_ms']:.3f} ms {card}")
    for nb in BLOCKED_NB:
        L = blocked_cholesky(A, nb=nb, device=A.device)
        g = gblup_solve_lower(Kc, y, LAM, nb=nb)
        torch.cuda.synchronize()
        err_L = float((L - L_ref).abs().max()) / scale
        rel = float((g - gebv).abs().max() / gebv.abs().max())
        finite = bool(torch.isfinite(g).all())
        del L, g
        b = -(-n // nb)
        Ab = Am[:b, :b].contiguous()  # a diagonal block: its factor and its inverse, nb times a factor
        eye = torch.eye(b, device=Ab.device)
        diag_ms = nb * cuda_ms(lambda: torch.linalg.solve_triangular(
            torch.linalg.cholesky_ex(Ab)[0], eye, upper=False), reps=10)
        rec = dict(solve_ms=wall_median_s(lambda: gblup_solve_lower(Kc, y, LAM, nb=nb), 5) * 1e3,
                   factor_ms=cuda_ms(lambda: blocked_cholesky(A, nb=nb, device=A.device), reps=5),
                   diagonal_blocks_ms=diag_ms, gebv_rel=rel, L_rel=err_L)
        out[f"nb={nb}"] = rec
        print(f"solver n={n}, lam={LAM:g}: blocked nb={nb} (panels of {b}) solve median "
              f"{rec['solve_ms']:.3f} ms ({rec['solve_ms'] / out['cusolver']['solve_ms']:.2f}x "
              f"cuSOLVER's), blocked_cholesky {rec['factor_ms']:.3f} ms, of it ~{diag_ms:.3f} ms the "
              f"{nb} diagonal blocks' cholesky_ex + solve_triangular; max|Δ GEBV|/max|GEBV| against "
              f"cuSOLVER {rel:.3g}, max|L - cholesky|/max|L| {err_L:.3g} {card}")
        check(finite and rel <= GEBV_TOL and err_L <= CHOL_TOL, f"the blocked solver at nb={nb}")
    del A, Am, L_ref
    return out


GWAS_SCANS = ("gwasols", "gwaslmm", "gwasreml")
GWAS_COR_MIN, GWAS_S2_TOL = 0.999, 1e-3  # card vs device="cpu": statistic cor; gwaslmm σ² relative


def gwas_phase(gbm, dev, card, X_big=None, width=(2048, 32_768)) -> tuple:
    """Phase 11, GWAS, with the launch counters set to 0 just before it;
    returns the counts it launched and (b)'s statistics per scan (phase 16
    holds the mesh dispatch to them).

    (a) a 256x2048 QTL panel as tests/test_gwas.py's `gwas_data` makes it
    (simulate_genomes(seed=42) rounded to tetraploid calls, h² = 0.5 on 5
    QTL): gwasols, gwaslmm and gwasreml on the card and with device="cpu":
    the same loci, cor >= GWAS_COR_MIN for each scan's statistics, one
    argmax marker across the six fits, gwaslmm's σ²ₑ and σ²ᵤ within
    GWAS_S2_TOL relative;
    (b) the JAX bench's `gwas` cell (bench.py:448-519) at `width`: a
    default_rng(3) panel of integers 0-2 over 2 with one normal trait; the
    upload measurement (`upload_line`); gwasreml cold (prep cache cleared)
    and warm, then gwasols and gwaslmm on the cached prep: markers/s each,
    gwasreml's stage split, peak device memory, every statistic finite;
    (c) with X_big (phase 7's 10,000-entry panel), `eigh_line`.
    """
    import numpy as np
    import torch

    from genomicbreedingmodels_tpu_torch.models import gwas as gwas_mod

    cuda = torch.device(dev).type == "cuda"
    gbm.reset_launches()

    # -- (a) the card against device="cpu" on a QTL panel --------------------------
    g = gbm.simulate_genomes(n=256, l=2048, seed=42)
    g = gbm.Genomes(entries=g.entries, populations=g.populations, loci_alleles=g.loci_alleles,
                    allele_frequencies=np.round(g.allele_frequencies * 4) / 4)
    pv = np.zeros((9, 1))
    pv[0, 0] = 0.5
    tr, _ = gbm.simulate_trials(g, f_add_dom_epi=np.array([[0.05, 0.0, 0.0]]),
                                proportion_of_variance=pv, n_qtl=5, seed=42)
    ph = gbm.extract_phenomes(tr)
    fits, secs = {}, {}
    for d in (dev, "cpu"):
        t0 = time.perf_counter()
        fits[d] = {name: getattr(gbm, name)(g, ph, device=d) for name in GWAS_SCANS}
        secs[d] = time.perf_counter() - t0
    parts, tops, verdicts = [], [], []
    for name in GWAS_SCANS:
        a, b = fits[dev][name], fits["cpu"][name]
        cor = float(np.corrcoef(a.b_hat, b.b_hat)[0, 1])
        tops += [int(np.argmax(np.abs(a.b_hat))), int(np.argmax(np.abs(b.b_hat)))]
        parts.append(f"{name} cor={cor:.7f}")
        verdicts.append((np.array_equal(a.b_hat_labels, b.b_hat_labels), f"GWAS (a) {name}: same loci"))
        verdicts.append((bool(np.all(np.isfinite(a.b_hat))) and cor >= GWAS_COR_MIN,
                         f"GWAS (a) {name}: card vs cpu cor"))
    la, lb = fits[dev]["gwaslmm"].extras, fits["cpu"]["gwaslmm"].extras
    s2 = {k: abs(la[k] - lb[k]) / abs(lb[k]) for k in ("sigma2_e", "sigma2_u")}
    print(f"GWAS (a) 256x2048 QTL panel, card vs device='cpu': " + "; ".join(parts)
          + f"; argmax markers {tops}; gwaslmm sigma2_e {la['sigma2_e']:.7g} ({lb['sigma2_e']:.7g}), "
          f"sigma2_u {la['sigma2_u']:.7g} ({lb['sigma2_u']:.7g}); card {secs[dev]:.3f} s, "
          f"cpu {secs['cpu']:.3f} s {card}")
    for ok, what in verdicts:
        check(ok, what)
    check(len(set(tops)) == 1, "GWAS (a): one argmax marker across the three scans and both devices")
    check(max(s2.values()) <= GWAS_S2_TOL, "GWAS (a): gwaslmm sigma2 within 1e-3 of the cpu's")

    # -- (b) the bench's gwas cell ------------------------------------------------------
    n, p = width
    rng = np.random.default_rng(3)
    freq = rng.integers(0, 3, size=(n, p)).astype(np.float64) / 2.0
    G = gbm.Genomes(entries=np.array([f"e{i:05d}" for i in range(n)]),
                    populations=np.array(["pop_1"] * n),
                    loci_alleles=np.array([f"chr1\t{i}\tA|T\tA" for i in range(p)]),
                    allele_frequencies=freq)
    P = gbm.Phenomes(entries=G.entries, populations=G.populations, traits=np.array(["t"]),
                     phenotypes=rng.normal(size=(n, 1)))
    if cuda:
        upload_line(freq, card)
        torch.cuda.reset_peak_memory_stats()
    gwas_mod._PREP_CACHE.clear()
    for call in ("cold", "warm"):
        t0 = time.perf_counter()
        fit = gbm.gwasreml(G, P, device=dev)
        t = time.perf_counter() - t0
        split = " ".join(f"{k}={v['total_s']:.3f}s" for k, v in fit.extras["timings"].items())
        print(f"GWAS (b) gwasreml {n}x{p}, {call} (prep cache {'cleared' if call == 'cold' else 'hit'}): "
              f"{t:.3f} s, {p / t:.6g} markers/s ({split}) {card}")
        check(bool(np.all(np.isfinite(fit.b_hat))) and len(fit.b_hat) == p, f"gwasreml {call} finite")
    cell_stats = {"gwasreml": fit.b_hat}
    for name in ("gwasols", "gwaslmm"):
        t0 = time.perf_counter()
        fit = getattr(gbm, name)(G, P, device=dev)
        t = time.perf_counter() - t0
        print(f"GWAS (b) {name} {n}x{p}, prep cached: {t:.3f} s, {p / t:.6g} markers/s {card}")
        check(bool(np.all(np.isfinite(fit.b_hat))) and len(fit.b_hat) == p, f"{name} finite")
        cell_stats[name] = fit.b_hat
    if cuda:
        print(f"GWAS (b) peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
              f"(phase 7's 4.1 GB panel resident) {card}")
    gwas_mod._PREP_CACHE.clear()
    del freq, G

    if X_big is not None:
        eigh_line(X_big, card)
    launched = dict(gbm.LAUNCHES)
    if cuda:
        check(launched["gram_tri_float"] > 0, "phase 11 launched K2")
    return launched, cell_stats


# Phase 12's traits: a genetic correlation, heritabilities (trait 2 the noisy
# one, 10 % of its records missing), and the checks' tolerances.
MT_RG = ((1.0, 0.9, 0.5, 0.3), (0.9, 1.0, 0.4, 0.2), (0.5, 0.4, 1.0, 0.6), (0.3, 0.2, 0.6, 1.0))
MT_H2 = (0.7, 0.15, 0.4, 0.3)
MT_COV_TOL, MT_RG_TOL, MT_ENV_TOL = 1e-3, 0.1, 1e-3
# gblup_multienv's σ²ₑ on phase 12 (d)'s trials, card against device="cpu":
# σ²ᵤ sits on its REML bound, and the CPU path's GRM, rounded to f32, leaves
# its σ²ₑ 4.4e-3 from an all-f64 fit (4.7e-3 with an f64 eigh on it; the f32
# eigh alone moves σ²ₑ 1.1e-3, an f64 REML scan 4.6e-6;
# scripts/torch_multienv_grm_sensitivity.py). The card is held to the f64
# fit at MT_ENV_TOL.
MT_ENV_E_TOL = 1e-2


def multienv_f64_witness(gbm, genomes, trials, grm: bool = True, eigh: bool = True):
    """`gblup_multienv(genomes, trials, device="cpu")` with its GRM an f64
    product of the centred panel on the host (`grm`) and its
    eigendecomposition in f64 (`eigh`); the CPU path rounds the GRM to f32
    and eigendecomposes in f32. GRM_type "simple" only."""
    import numpy as np
    import torch

    mt = importlib.import_module("genomicbreedingmodels_tpu_torch.models.multitrait")
    from genomicbreedingmodels_tpu_torch.core.grm import GRMResult

    def grm_f64(X, GRM_type, dev):
        assert GRM_type == "simple"
        Z = np.asarray(X, dtype=np.float64)
        f = Z.mean(axis=0)
        Z = Z - f
        denom = 2.0 * float(np.sum(f * (1.0 - f)))
        denom = denom if denom > 1e-12 else 1.0
        return GRMResult(genomic_relationship_matrix=torch.from_numpy(Z @ Z.T / denom),
                         denominator=denom, ploidy=2)

    def eigh_f64(K):
        Kd = K.double()
        s, U = torch.linalg.eigh(0.5 * (Kd + Kd.mT))
        return torch.clamp(s, min=0.0).to(K.dtype), U.to(K.dtype)

    saved = mt.grm_of_type, mt._eigh_device
    mt.grm_of_type = grm_f64 if grm else saved[0]
    mt._eigh_device = eigh_f64 if eigh else saved[1]
    try:
        return gbm.gblup_multienv(genomes, trials, device="cpu")
    finally:
        mt.grm_of_type, mt._eigh_device = saved


def multitrait_phase(gbm, dev, card, X_big, g_env, n_cut: int = 512, p_cut: int = 4096) -> dict:
    """Phase 12, multi-trait and multi-environment GBLUP (BASELINE config 5's
    model), with the launch counters set to 0 just before it; returns the
    counts it launched.

    X_big: phase 7's dosage panel on the card (dosages/2; 10,000 x 102,000).
    Four traits with genetic correlation MT_RG and heritabilities MT_H2 are
    made on the card from four independent sparse marker-effect vectors, and
    10 % of trait 2's records are set missing. The panel goes to the host and
    into a `Genomes`.
    (a) `gblup_multitrait_cov` (missing_policy="em") on a 90 % training
    split: its stages (grm, eigh, em, effects), the fitted genetic
    correlation of trait 1 and the noisy trait 2 within MT_RG_TOL of the
    simulated genetic values' own (the other pairs are printed: on unrelated
    entries with p >> n the REML estimates of the weaker correlations carry
    a sampling error near 0.1 at this size), and trait 2's validation GEBV
    correlation with its genetic values above that of its single-trait
    `gblup`;
    (b) `gblup_multitrait` on the three complete traits, same split;
    (c) `gblup_multitrait_cov` on an n_cut x p_cut cut of the same data, on
    the card and with device="cpu": G_g and R within MT_COV_TOL relative;
    (d) `gblup_multienv` on a 3-year x 2-site trial set simulated on
    `g_env` (phase 6's 2048x16384 panel), the card against an all-f64 fit
    on the host (`multienv_f64_witness`): σ²ᵤ, σ²ₑ and σ²_env within
    MT_ENV_TOL relative, y_pred cor >= 0.9999; and against device="cpu":
    σ²ᵤ and σ²_env within MT_ENV_TOL, σ²ₑ within MT_ENV_E_TOL, y_pred cor
    >= 0.9999.
    """
    import numpy as np
    import torch

    cuda = torch.device(dev).type == "cuda"
    gbm.reset_launches()
    n, p = X_big.shape
    gen = torch.Generator(device=X_big.device)
    gen.manual_seed(12)
    t0 = time.perf_counter()
    B = torch.randn(p, 4, device=X_big.device, generator=gen)
    B *= torch.rand(p, 4, device=X_big.device, generator=gen) < 0.01  # 1 % causal per score
    A = X_big @ B
    A = (A - A.mean(dim=0)) / A.std(dim=0)  # four independent genetic scores
    L = torch.linalg.cholesky(torch.tensor(MT_RG, device=X_big.device))
    Gv = A @ L.T
    h2 = torch.tensor(MT_H2, device=X_big.device)
    Y = h2.sqrt() * Gv + (1.0 - h2).sqrt() * torch.randn(n, 4, device=X_big.device, generator=gen)
    Gv, Y = Gv.double().cpu().numpy(), Y.double().cpu().numpy()
    rng = np.random.default_rng(12)
    Y[rng.choice(n, n // 10, replace=False), 1] = np.nan
    entries = np.array([f"e{i:05d}" for i in range(n)])
    G = gbm.Genomes(entries=entries, populations=np.array(["pop_1"] * n),
                    loci_alleles=np.array([f"chr1\t{i}\tA|T\tA" for i in range(p)]),
                    allele_frequencies=X_big.cpu().numpy())
    P = gbm.Phenomes(entries=entries, populations=G.populations,
                     traits=np.array([f"trait_{k + 1}" for k in range(4)]), phenotypes=Y)
    print(f"multi-trait data {n}x{p} (no cut of entries, markers or traits), t=4, "
          f"{int(np.isnan(Y[:, 1]).sum())} of trait_2's records missing: {time.perf_counter() - t0:.2f} s "
          f"(traits on the card, panel to a host Genomes) {card}")
    perm = rng.permutation(n)
    va, tr = np.sort(perm[: n // 10]), np.sort(perm[n // 10 :])

    # -- (a) the covariance model at size ---------------------------------------------
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fits = gbm.gblup_multitrait_cov(G, P, idx_entries=tr, device=dev)
    t = time.perf_counter() - t0
    ex = fits[0].extras
    split = " ".join(f"{k}={v:.3f}s" for k, v in ex["stage_seconds"].items())
    peak = f", peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB" if cuda else ""
    print(f"MT (a) gblup_multitrait_cov {len(tr)}x{p} t=4, missing_policy='em': {t:.3f} s ({split}){peak} {card}")
    sim = np.corrcoef(Gv[tr].T)
    d_rg = abs(float(ex["genetic_correlations"][0, 1]) - float(sim[0, 1]))
    print("MT (a) genetic correlations fitted / simulated: "
          + " ".join(f"({i + 1},{j + 1}) {ex['genetic_correlations'][i, j]:.3f}/{sim[i, j]:.3f}"
                     for i in range(4) for j in range(i + 1, 4))
          + "; h2 " + " ".join(f"{f.extras['h2']:.3f}" for f in fits) + f" {card}")
    check(all(np.all(np.isfinite(f.b_hat)) for f in fits), "gblup_multitrait_cov at size finite")
    check(d_rg <= MT_RG_TOL, "gblup_multitrait_cov: r_g(trait_1, trait_2) within 0.1 of the simulated")
    t0 = time.perf_counter()
    single = gbm.gblup(G, P, idx_entries=tr, idx_trait=1, device=dev)
    t_single = time.perf_counter() - t0
    cor_mt = float(np.corrcoef(gbm.predict(fits[1], G, va, device=dev), Gv[va, 1])[0, 1])
    cor_st = float(np.corrcoef(gbm.predict(single, G, va, device=dev), Gv[va, 1])[0, 1])
    print(f"MT (a) trait_2 (h2 {MT_H2[1]}, 10 % missing), validation cor(GEBV, g): multi-trait {cor_mt:.4f}, "
          f"single-trait gblup {cor_st:.4f} ({t_single:.3f} s) {card}")
    check(cor_mt > cor_st, "the noisy trait borrows strength: multi-trait beats single-trait gblup")
    # The EM's per-eigen-index t×t algebra, batched f64 on the card against the
    # same torch code on the host, at the training size (20 iterations, no
    # early stop, on synthetic rotated traits).
    s_syn = torch.linspace(0.0, 3.0, len(tr), dtype=torch.float64) ** 2
    Yt_syn = torch.randn(len(tr), 4, dtype=torch.float64, generator=torch.Generator().manual_seed(3))
    Yt_syn *= (s_syn[:, None] + 1.0).sqrt()
    gbm.mtgblup_em(Yt_syn, s_syn, n_iter=2, tol=0.0, device=dev)  # warm-up
    em_ms = {}
    for d in (dev, "cpu"):
        t0 = time.perf_counter()
        gbm.mtgblup_em(Yt_syn, s_syn, n_iter=20, tol=0.0, device=d)
        em_ms[d] = (time.perf_counter() - t0) / 20 * 1e3
    print(f"MT (a) mtgblup_em {len(tr)} x 4, 20 iterations: {em_ms[dev]:.2f} ms per iteration on the "
          f"card, {em_ms['cpu']:.2f} ms with device='cpu' {card}")

    # -- (b) independent per-trait GBLUP on the complete traits ----------------------
    t0 = time.perf_counter()
    per = gbm.gblup_multitrait(G, P.slice(idx_traits=[0, 2, 3]), idx_entries=tr, device=dev)
    t = time.perf_counter() - t0
    print(f"MT (b) gblup_multitrait {len(tr)}x{p}, 3 complete traits (one GRM, one eigh): {t:.3f} s; "
          + " ".join(f"{f.trait} h2={f.extras['h2']:.3f}" for f in per) + f" {card}")
    check(all(np.all(np.isfinite(f.y_pred)) for f in per), "gblup_multitrait finite")
    del G, P, single, fits, per

    # -- (c) the card against device="cpu" on a cut ------------------------------------
    Gc = gbm.Genomes(entries=entries[:n_cut], populations=np.array(["pop_1"] * n_cut),
                     loci_alleles=np.array([f"chr1\t{i}\tA|T\tA" for i in range(p_cut)]),
                     allele_frequencies=X_big[:n_cut, :p_cut].cpu().numpy())
    Pc = gbm.Phenomes(entries=Gc.entries, populations=Gc.populations,
                      traits=np.array([f"trait_{k + 1}" for k in range(4)]), phenotypes=Y[:n_cut])
    cut = {d: gbm.gblup_multitrait_cov(Gc, Pc, device=d)[0].extras for d in (dev, "cpu")}
    rel = {k: float(np.abs(cut[dev][k] - cut["cpu"][k]).max() / np.abs(cut["cpu"][k]).max())
           for k in ("genetic_covariance", "residual_covariance")}
    print(f"MT (c) gblup_multitrait_cov {n_cut}x{p_cut} card vs device='cpu': max|Δ G_g|/max|G_g| "
          f"{rel['genetic_covariance']:.3g}, max|Δ R|/max|R| {rel['residual_covariance']:.3g} {card}")
    check(max(rel.values()) <= MT_COV_TOL, "gblup_multitrait_cov: card G_g and R within 1e-3 of cpu")

    # -- (d) multi-environment GBLUP ---------------------------------------------------
    pv = np.array([[0.5], [0.2], [0.0], [0.1], [0.0], [0.0], [0.0], [0.0]])
    trials, _ = gbm.simulate_trials(g_env, n_years=3, n_sites=2, n_replications=2,
                                    f_add_dom_epi=np.array([[0.5, 0.0, 0.0]]),
                                    proportion_of_variance=pv, seed=5)
    env, secs = {}, {}
    for d in (dev, "cpu", "f64"):
        t0 = time.perf_counter()
        env[d] = (multienv_f64_witness(gbm, g_env, trials) if d == "f64"
                  else gbm.gblup_multienv(g_env, trials, device=d))
        secs[d] = time.perf_counter() - t0
    a = env[dev].extras
    comps = ("sigma2_u", "sigma2_e", "sigma2_env")
    rel, cor = {}, {}
    for ref in ("cpu", "f64"):
        b = env[ref].extras
        rel[ref] = {k: abs(a[k] - b[k]) / abs(b[k]) for k in comps}
        cor[ref] = float(np.corrcoef(env[dev].y_pred, env[ref].y_pred)[0, 1])
    print(f"MT (d) gblup_multienv {g_env.n}x{g_env.p}, {a['n_environments']} environments, "
          f"{len(trials.entries)} records, card (device='cpu'; all-f64 fit): "
          + " ".join(f"{k} {a[k]:.7g} ({env['cpu'].extras[k]:.7g}; {env['f64'].extras[k]:.7g})"
                     for k in comps)
          + "; card vs cpu: " + " ".join(f"{k} {v:.3g}" for k, v in rel["cpu"].items())
          + f", y_pred cor {cor['cpu']:.8f}; card vs f64: "
          + " ".join(f"{k} {v:.3g}" for k, v in rel["f64"].items())
          + f", y_pred cor {cor['f64']:.8f}; card {secs[dev]:.3f} s, cpu {secs['cpu']:.3f} s, "
          f"f64 {secs['f64']:.3f} s {card}")
    check(max(rel["f64"].values()) <= MT_ENV_TOL and cor["f64"] >= 0.9999,
          "gblup_multienv card vs the all-f64 fit: sigma2_u, sigma2_e, sigma2_env and y_pred")
    check(max(rel["cpu"]["sigma2_u"], rel["cpu"]["sigma2_env"]) <= MT_ENV_TOL and cor["cpu"] >= 0.9999,
          "gblup_multienv card vs cpu: sigma2_u, sigma2_env and y_pred")
    check(rel["cpu"]["sigma2_e"] <= MT_ENV_E_TOL, "gblup_multienv card vs cpu: sigma2_e")
    launched = dict(gbm.LAUNCHES)
    if cuda:
        check(launched["gram_tri_int8"] + launched["gram_tri_float"] > 0, "phase 12 launched K1 or K2")
    return launched


# Phase 13: pinned BRR folds against their closed form (GEBV correlation);
# BayesC fold chains on the card against device="cpu" (pooled y_pred
# correlation: two chains of other generators, 150 kept sweeps each).
FOLD_CLOSED_COR, FOLD_CARD_CPU_COR = 0.999, 0.95
FOLD_SWEEPS, FOLD_BURN = 200, 50  # the chains of phase 13 (b)
K3_FOLDS = 15  # the cv cell's 3 x 5 folds
# Phase 14: selected names outside boundary ties (float64 |slope| within this
# of the k-th selected one), and values of common names.
EPI_BOUNDARY_REL, EPI_VALUE_TOL = 1e-5, 1e-6


def fold_phase(gbm, dev, card: str, cvbulk_bayesc_s: float, width=(2048, 32_768)) -> tuple:
    """Phase 13, the fold-batched Bayesian CV chains, with the launch
    counters set to 0 just before it; returns the counts it launched and
    (b)'s CVs (phase 16 holds the mesh dispatch to them).

    (a) at n=256, p=2048 (phase 10 (a)'s called panel), 1 x 3 folds:
    pinned-variance BRR fold chains on the card, each fold's GEBVs against
    its training rows' closed-form conjugate mean (cor >= FOLD_CLOSED_COR);
    `cvbulk_batched` over bayesc on the card and with device="cpu" (the same
    tags and validation entries, pooled y_pred cor >= FOLD_CARD_CPU_COR);
    the chain's first fold-batched K3 call held against its three single
    launches and the plain version, after the phase's counts are read;
    (b) the JAX bench's `cv` cell (2048x32768, 3x5 folds) through
    `cvbulk_batched` over bayesc, bayesian_ridge and bayesian_lasso at 200
    sweeps (50 burn-in), one call with the device caches cleared (a warm
    repeat differed only by the 0.17 s h2d+gram stage, which phase 10 (b)
    shows too): stage split, K3 launched sweeps x blocks times per bayesc
    call (one launch per block for all 15 folds),
    peak memory, and bayesc's time per fold and sweep beside phase 10 (c)'s
    `cvbulk` (`cvbulk_bayesc_s`, 5 folds of CV_C_SWEEPS sweeps)."""
    import numpy as np
    import torch

    from genomicbreedingmodels_tpu_torch.cv import batched as cv_batched

    bayes_mod = importlib.import_module("genomicbreedingmodels_tpu_torch.models.bayesian")
    on_card = torch.device(dev).type == "cuda"
    gbm.reset_launches()

    # -- (a) small: the closed form, the card against the CPU, the first K3 call ----------
    g = gbm.simulate_genomes(n=256, l=2048, seed=5)
    trials, _ = gbm.simulate_trials(g, f_add_dom_epi=np.array([[0.4, 0.05, 0.05]]), seed=5)
    ph = gbm.extract_phenomes(trials)
    g = gbm.Genomes(entries=g.entries, populations=g.populations, loci_alleles=g.loci_alleles,
                    allele_frequencies=np.rint(2.0 * g.allele_frequencies) / 2.0)
    X, y = g.allele_frequencies, ph.phenotypes[:, 0]
    labels = np.random.default_rng(7).integers(0, 3, size=g.n)
    masks = np.stack([labels != f for f in range(3)]).astype(np.float32)
    sig_e2 = 0.5 * float(np.var(y))
    sig_b2 = 0.5 * float(np.var(y)) / float(np.sum(np.var(X, axis=0)))
    t0 = time.perf_counter()
    mu, b = gbm.gibbs_cv_folds(X, y, masks, model="BRR", n_iter=3200, n_burnin=200, seed=3,
                               fix_sigma_e2=sig_e2, fix_sigma_b2=sig_b2, device=dev)
    t = time.perf_counter() - t0
    cors = []
    for f in range(3):
        m = masks[f] > 0
        Z, yc = X[m] - X[m].mean(0), y[m] - y[m].mean()
        alpha = np.linalg.solve(Z @ Z.T + (sig_e2 / sig_b2) * np.eye(int(m.sum())), yc)
        b_star = Z.T @ alpha  # the ridge mean in its dual form (p > n)
        cors.append(float(np.corrcoef(mu[f] + X @ b[f], y[m].mean() + (X - X[m].mean(0)) @ b_star)[0, 1]))
    print(f"folds (a) pinned BRR 256x2048 1x3 folds, 3000 kept sweeps: GEBV cor with each fold's "
          f"closed form {', '.join(f'{c:.6f}' for c in cors)}; {t:.3f} s {card}")
    check(min(cors) >= FOLD_CLOSED_COR, "pinned BRR folds against their closed form")

    first = []
    kernel_step = bayes_mod._block_kernel

    def keep_first(*args):
        if not first:
            first.extend(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
        return kernel_step(*args)

    kw = dict(models=("bayesc",), n_replications=1, n_folds=3, seed=7, mcmc_n_iter=FOLD_SWEEPS,
              mcmc_n_burnin=FOLD_BURN)
    bayes_mod._block_kernel = keep_first
    try:
        k0 = gbm.LAUNCHES["gibbs_group"]
        (card_cvs, _), t_card = run_checked(dev, gbm.cvbulk_batched, g, ph, device=dev, **kw)
        k3_small = gbm.LAUNCHES["gibbs_group"] - k0
    finally:
        bayes_mod._block_kernel = kernel_step
    (cpu_cvs, _), t_cpu = run_checked("cpu", gbm.cvbulk_batched, g, ph, device="cpu", **kw)
    check(keys(card_cvs) == keys(cpu_cvs) and len(card_cvs) == 3, "bayesc folds: the same CV tags")
    check(all(np.array_equal(a.validation_entries, c.validation_entries)
              for a, c in zip(card_cvs, cpu_cvs)), "bayesc folds: the same validation entries")
    ya = np.concatenate([cv.y_pred for cv in card_cvs])
    yb = np.concatenate([cv.y_pred for cv in cpu_cvs])
    cor = float(np.corrcoef(ya, yb)[0, 1])
    print(f"folds (a) cvbulk_batched bayesc 256x2048 1x3 folds, {FOLD_SWEEPS} sweeps: pooled y_pred "
          f"cor card vs cpu {cor:.5f}; K3 launches {k3_small}; card {t_card:.3f} s, cpu {t_cpu:.3f} s "
          f"{card}")
    check(np.all(np.isfinite(ya)) and cor >= FOLD_CARD_CPU_COR, "bayesc folds: card against cpu")
    if on_card:
        check(k3_small == FOLD_SWEEPS * 8, "bayesc folds 256x2048: one K3 launch per block and sweep")

    # -- (b) the cv cell at width: three Bayesian models over 15 folds, one cold call --------
    (n, p), reps, folds = width, 3, 5
    models = ("bayesc", "bayesian_ridge", "bayesian_lasso")
    G, P = cv_cell(gbm, n, p)
    bs = 258  # mcmc_block_size 256 rounded up to whole groups of K = 6
    n_blocks = -(-p // bs)
    gbm.clear_device_caches()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    for call in ("cold",):
        k0 = gbm.LAUNCHES["gibbs_group"]
        (cvs, _), t = run_checked(dev, gbm.cvbulk_batched, G, P, models=models, n_replications=reps,
                                  n_folds=folds, store_effects=False, mcmc_n_iter=FOLD_SWEEPS,
                                  mcmc_n_burnin=FOLD_BURN, device=dev)
        k3 = gbm.LAUNCHES["gibbs_group"] - k0
        stages = cv_batched.LAST_TIMER.summary()
        split = " ".join(f"{k}={v['total_s']:.3f}s" for k, v in stages.items())
        print(f"folds (b) cvbulk_batched {n}x{p} {reps}x{folds} folds x {len(models)} Bayesian models, "
              f"{FOLD_SWEEPS} sweeps, {call}: {t:.3f} s ({split}); K3 launches {k3} {card}")
        check(len(cvs) == reps * folds * len(models), f"Bayesian cv cell {call}: 45 CVs")
        check(all(np.isfinite(cv.metrics["cor"]) and np.all(np.isfinite(cv.y_pred)) for cv in cvs),
              f"Bayesian cv cell {call}: finite metrics")
        if on_card:
            check(k3 == FOLD_SWEEPS * n_blocks,
                  f"Bayesian cv cell {call}: K3 launched sweeps x blocks = {FOLD_SWEEPS * n_blocks} times")
        per_fold = stages["bayesc_solve"]["total_s"] / (reps * folds)
        cvbulk_per_fold = cvbulk_bayesc_s / 5 * FOLD_SWEEPS / CV_C_SWEEPS  # at FOLD_SWEEPS sweeps
        print(f"folds (b) bayesc per fold: {per_fold:.4f} s fold-batched (bayesc_solve / {reps * folds}) "
              f"against {cvbulk_per_fold:.4f} s per fold for phase 10 (c)'s cvbulk (its "
              f"{CV_C_SWEEPS} sweeps scaled to {FOLD_SWEEPS}), {cvbulk_per_fold / per_fold:.1f}x {card}")
    cors = {m: float(np.mean([cv.metrics["cor"] for cv in cvs if cv.fit.model == m])) for m in models}
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else float("nan")
    print("folds (b) mean validation cor: " + " ".join(f"{m}={c:.4f}" for m, c in cors.items())
          + f"; peak memory {peak:.2f} GiB {card}")
    counts = dict(gbm.LAUNCHES)  # the path's own launches; the hold below launches K3 too
    if on_card:  # (a)'s first fold-batched block against its single launches and the plain version
        Fk, bs_k = first[0].shape[0], first[0].shape[-1]
        k3_fold_check(first[:9], first[9], f"F={Fk} bs={bs_k} K={first[9]}, the chain's first block")
    return counts, cvs


def epistasis_phase(gbm, dev, card: str, small=(256, 2048), cell=(512, 16_384),
                    features=(512, 2048)) -> dict:
    """Phase 14, the epistasis feature engine, with the launch counters set
    to 0 just before it; returns the counts (it runs no hand kernel: the
    pair scan is XLA in the JAX package and torch products here).

    (a) `transform2` with mult, addnorm and raise_ at n x l = `small`, the
    card against device="cpu": the same selected names outside boundary
    ties (float64 |slope| within EPI_BOUNDARY_REL of the k-th) and the same
    values (EPI_VALUE_TOL) on common names;
    (b) the JAX bench's `epistasis` cell (bench.py:530-560, n=512,
    l=16384, k=1000) with mult and addnorm, cold (device caches cleared)
    and warm, as seconds and pairs/s = l²/t; then `epistasisfeatures` with
    n_reps=1 at `features`."""
    import numpy as np
    import torch

    gbm.reset_launches()

    def panel(n, l, seed):
        rng = np.random.default_rng(seed)
        freq = rng.uniform(size=(n, l))
        G = gbm.Genomes(entries=np.array([f"e{i:05d}" for i in range(n)]),
                        populations=np.array(["pop_1"] * n),
                        loci_alleles=np.array([f"chr1\t{i}\tA|T\tA" for i in range(l)]),
                        allele_frequencies=freq)
        yy = freq[:, :32] @ rng.normal(size=32) + rng.normal(size=n)
        return G, gbm.Phenomes(entries=G.entries, populations=G.populations, traits=np.array(["t"]),
                               phenotypes=yy[:, None])

    def slopes(out, yy):
        T = out.allele_frequencies
        Tm, ym = T - T.mean(0), yy - yy.mean()
        return np.abs((Tm.T @ ym) / np.maximum((Tm * Tm).sum(0), 1e-30))

    def sync():
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()

    # -- (a) card against the CPU ---------------------------------------------------------
    G, P = panel(*small, seed=5)
    yy = P.phenotypes[:, 0]
    for f in (gbm.mult, gbm.addnorm, gbm.raise_):
        outs, secs = {}, {}
        for d in (dev, "cpu"):
            t0 = time.perf_counter()
            outs[d] = gbm.transform2(f, G, P, device=d)
            sync()
            secs[d] = time.perf_counter() - t0
        a, c = outs[dev], outs["cpu"]
        na, nc = list(a.loci_alleles), list(c.loci_alleles)
        sa, sc = dict(zip(na, slopes(a, yy))), dict(zip(nc, slopes(c, yy)))
        kth = min(sc.values())
        diff = set(na) ^ set(nc)
        outside = [nm for nm in diff if abs(sa.get(nm, sc.get(nm)) - kth) > EPI_BOUNDARY_REL * kth]
        common = [nm for nm in nc if nm in sa]
        err = float(np.abs(a.allele_frequencies[:, [na.index(nm) for nm in common]]
                           - c.allele_frequencies[:, [nc.index(nm) for nm in common]]).max())
        print(f"epistasis (a) transform2 {f.__name__} {small[0]}x{small[1]}: {len(na)} features, "
              f"{len(diff)} names differ card vs cpu ({len(outside)} outside boundary ties), "
              f"max |Δ value| {err:.3g}; card {secs[dev]:.3f} s, cpu {secs['cpu']:.3f} s {card}")
        check(len(na) == len(nc) > 0 and not outside and err <= EPI_VALUE_TOL,
              f"transform2 {f.__name__}: card against cpu")

    # -- (b) the bench's epistasis cell, cold and warm -------------------------------------
    n, l = cell
    G, P = panel(n, l, seed=5)
    for f in (gbm.mult, gbm.addnorm):
        gbm.clear_device_caches()
        for call in ("cold", "warm"):
            t0 = time.perf_counter()
            out = gbm.transform2(f, G, P, n_new_features_per_transformation=1000, device=dev)
            sync()
            t = time.perf_counter() - t0
            print(f"epistasis (b) transform2 {f.__name__} {n}x{l} k=1000, {call}: {t:.3f} s, "
                  f"{l * l / t:.4g} pairs/s, {out.p} features {card}")
            check(out.p > 0 and np.all(np.isfinite(out.allele_frequencies)),
                  f"epistasis cell {f.__name__} {call}")
    G, P = panel(*features, seed=6)
    t0 = time.perf_counter()
    out = gbm.epistasisfeatures(G, P, n_reps=1, device=dev)
    sync()
    t = time.perf_counter() - t0
    A = out.allele_frequencies
    print(f"epistasis (b) epistasisfeatures n_reps=1 {features[0]}x{features[1]}: {t:.3f} s, "
          f"{out.p - G.p} new features {card}")
    check(out.p > G.p and A.min() >= 0.0 and A.max() <= 1.0 + 1e-12, "epistasisfeatures in [0, 1]")
    rec = gbm.reconstitutefeatures(G, [str(nm) for nm in out.loci_alleles])
    check(np.array_equal(rec.allele_frequencies, A), "reconstitutefeatures round-trips")
    return dict(gbm.LAUNCHES)


# Phase 15: the JAX bench's out-of-core cells (bench.py:224-283 `diskstream`,
# a random complete .bed streamed in shards of DISK_CELL[2] markers;
# bench.py:132-216 `northstar`, NORTH_CELL[2] int8 shards synthesized on the
# card), a 512x4096 correctness panel, and the command line.
DISK_CELL = (25_000, 250_000, 31_250)  # n, p, block_cols
NORTH_CELL = (50_000, 500_000, 8)  # n, p, shards
OOC_CG_ITERS, OOC_SEED = 30, 15
# grm_from_bed on the card: against the in-memory K1 Gram of the same calls
# (both exact int32, then the same f32 epilogue), and against device="cpu"
# (the CPU's f32 centering and, for imputed shards, K2 against float64).
OOC_MEM_TOL, OOC_CPU_TOL = 1e-6, 1e-5
# The pieces CG against the dense Cholesky: GEBV = y_c - λα, so a CG residual
# r moves the GEBV by at most λ‖Δα‖ <= λ‖r‖/λ_min(K + λI) <= ‖r‖; the rest is
# float32 rounding of the two solves, OOC_GEBV_REL·max|GEBV|.
OOC_GEBV_REL = 1e-4
CLI_TOL = 1e-5  # CLI against the Python API: GEBVs and the streamed GRM, over their max


def h2d_line(card: str, mb: int = 256) -> None:
    """Prints the host→device GB/s of one `mb` MB copy from pageable and from
    pinned memory (best of 3), as the JAX bench's link probe (bench.py:92)."""
    import torch

    rates = {}
    for label, pin in (("pageable", False), ("pinned", True)):
        host = torch.empty(mb * 2**20, dtype=torch.uint8, pin_memory=pin)
        dev = torch.empty_like(host, device="cuda")
        best = min(cuda_ms(lambda: dev.copy_(host, non_blocking=pin), reps=3) for _ in range(3))
        rates[label] = host.numel() / best / 1e6
    print(f"h2d {mb} MB: pageable {rates['pageable']:.2f} GB/s, pinned {rates['pinned']:.2f} GB/s "
          f"(CUDA events, best of 3) {card}")


def outofcore_phase(gbm, dev, card: str, called, phenomes, small=(512, 4096), disk=DISK_CELL,
                    north=NORTH_CELL, cli_block_cols: int = 4096) -> tuple:
    """Phase 15, the out-of-core path and the command line, with the launch
    counters set to 0 just before it; returns (the counts it launched, the
    K1 timings at the shapes of (b) and (c), taken after the counts).

    (a) `small` n x p: simulate_genomes snapped to {0, ½, 1}, written by
    `write_bed`, and a copy with 1 % missing calls: `read_bed` returns each
    exactly; `grm_from_bed` on the card against `gram_dosage` of the panel
    read back (OOC_MEM_TOL) and, on both files, against device="cpu"
    (OOC_CPU_TOL; the missing file's imputed shards take K2);
    `unpack_bed_payload` on the card bit-equal to the host decode with the
    same missing count; `gblup_from_bed_pieces` (300 CG iterations) within
    2e-3 of `gblup_from_bed` with a residual under 1e-3 (the JAX test's
    tolerances) and raising on missing calls.
    (b) the `diskstream` cell at `disk` = (n, p, block_cols): a
    `write_random_bed` trio under the temporary directory (reused when its
    size is right), a host-only pass, `gblup_from_bed_pieces` (λ = 0.1, 30
    CG iterations) and the dense `gblup_from_bed` (K1 per shard + Cholesky),
    SNPs/s with stage splits, peak memory, the per-shard device time of each
    path, the pinned and pageable h2d rates; GEBVs finite, the two within
    the CG residual + OOC_GEBV_REL·max|GEBV|.
    (c) the `northstar` cell at `north` = (n, p, shards): shards of p/shards
    int8 columns synthesized on the card; pieces (4096 wide) + center + 30
    CG iterations at lam_rel = 1e-3, then the same shards through K1, the
    raw int32 triangles added, scaled and centered once, `gblup_solve_lower`
    at the same λ: SNPs/s, stages and peak memory of each; GEBVs as in (b).
    (d) the command line in-process (`__main__.main`) on phase 6's called
    panel written as a .bed: `fit --model gblup` (K1) then `predict` against
    the Python API (CLI_TOL), `fit` with the default ridge (K2 in bf16),
    `grm --streaming` against `grm` in memory up to the VanRaden scale
    (CLI_TOL).
    """
    import tempfile

    import numpy as np
    import torch

    from genomicbreedingmodels_tpu_torch import streaming
    from genomicbreedingmodels_tpu_torch.__main__ import main as cli
    from genomicbreedingmodels_tpu_torch.io import write_random_bed
    from genomicbreedingmodels_tpu_torch.kernels.gram_tri import gram_tri_int8
    from genomicbreedingmodels_tpu_torch.native.lib import library_path, load_native
    from genomicbreedingmodels_tpu_torch.ops import pieces as pc
    from genomicbreedingmodels_tpu_torch.ops.chol import gblup_solve_lower
    from genomicbreedingmodels_tpu_torch.ops.grm import (
        _center_gram_lower,
        encode_dosage,
        entry_major,
        gram_dosage,
        gram_tri_snp_major,
    )
    from genomicbreedingmodels_tpu_torch.utils.logging import StageTimer

    cuda = torch.device(dev).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def peak_gib():
        return torch.cuda.max_memory_allocated() / 2**30 if cuda else float("nan")

    def reset_peak():
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def stages(timer):
        return " ".join(f"{k}={v:.3f}s" for k, v in timer.totals.items())

    gbm.reset_launches()
    check(load_native() is not None, "the port's native gbmio library builds and loads")
    print(f"native gbmio: {library_path()}")
    tmp = tempfile.TemporaryDirectory(prefix="gbm_ooc_")
    work = Path(tmp.name)
    try:
        # -- (a) correctness at `small` --------------------------------------------
        n, p = small
        g = gbm.simulate_genomes(n=n, l=p, seed=OOC_SEED)
        F = np.rint(2.0 * g.allele_frequencies) / 2.0
        Fm = F.copy()
        Fm[np.random.default_rng(OOC_SEED).random(F.shape) < 0.01] = np.nan
        files = {}
        for label, FF in (("complete", F), ("missing", Fm)):
            files[label] = work / label
            gbm.write_bed(gbm.Genomes(entries=g.entries, populations=g.populations,
                                      loci_alleles=g.loci_alleles, allele_frequencies=FF),
                          files[label])
            back = gbm.read_bed(files[label])
            exact = (np.array_equal(back.allele_frequencies, FF, equal_nan=True)
                     and np.array_equal(back.loci_alleles, g.loci_alleles)
                     and np.array_equal(back.entries, g.entries))
            check(exact, f"read_bed returns the written {label} panel")
        bc = 1000  # shards of 1000 markers and a last one of p % 1000: widths off the 16 grid
        K = streaming.grm_from_bed(files["complete"], block_cols=bc, device=dev)
        D = encode_dosage(gbm.read_bed(files["complete"]).allele_frequencies)
        K_mem = gram_dosage(D, device=dev)
        err_mem = float((K - K_mem).abs().max() / K_mem.abs().max())
        errs = {}
        for label, path in files.items():
            k2 = gbm.LAUNCHES["gram_tri_float"]
            Kd = streaming.grm_from_bed(path, block_cols=bc, device=dev).cpu()
            k2 = gbm.LAUNCHES["gram_tri_float"] - k2
            Kc = streaming.grm_from_bed(path, block_cols=bc, device="cpu")
            errs[label] = float((Kd - Kc).abs().max() / Kc.abs().max())
            check(errs[label] <= OOC_CPU_TOL, f"grm_from_bed {label} on the card vs device='cpu'")
            check((k2 > 0) == (label == "missing") or not cuda,
                  f"grm_from_bed {label}: K2 runs exactly for the imputed shards")
        check(err_mem <= OOC_MEM_TOL, "grm_from_bed vs gram_dosage of the panel read back")
        unpack_ok = []
        for label, FF in (("complete", F), ("missing", Fm)):
            st = streaming.BedShardStreamer(files[label], block_cols=bc)
            for a, b, payload in st.iter_payload():
                Dd, miss = pc.unpack_bed_payload(torch.from_numpy(payload).to(dev), st.n)
                expect = np.nan_to_num(FF[:, a:b].T * 2.0, nan=0.0).astype(np.int8)
                unpack_ok.append(torch.equal(Dd.cpu(), torch.from_numpy(expect))
                                 and int(miss) == int(np.isnan(FF[:, a:b]).sum()))
        check(all(unpack_ok), "unpack_bed_payload on the card equals the host decode")
        y = np.random.default_rng(OOC_SEED).normal(size=n)
        gp, resid = streaming.gblup_from_bed_pieces(files["complete"], y, lam=0.1, block_cols=bc,
                                                    block_rows=100, cg_iters=300, device=dev)
        gd, _ = streaming.gblup_from_bed(files["complete"], y, lam=0.1, block_cols=bc, device=dev)
        gap = float(np.abs(gp - gd.cpu().numpy()).max())
        try:
            streaming.gblup_from_bed_pieces(files["missing"], y, block_cols=bc, device=dev)
            rejected = False
        except ValueError as err:
            rejected = "missing" in str(err)
        print(f"OOC (a) {n}x{p}: read_bed exact (complete, 1 % missing); grm_from_bed card vs "
              f"gram_dosage {err_mem:.3g}, vs device='cpu' complete {errs['complete']:.3g} missing "
              f"{errs['missing']:.3g} (over max|K|); unpack_bed_payload bit-equal on "
              f"{len(unpack_ok)} shards; pieces CG (300 it., block_rows=100) vs dense max|Δ|="
              f"{gap:.3g} resid={resid:.3g}; missing calls rejected={rejected}")
        check(resid < 1e-3 and gap <= 2e-3, "gblup_from_bed_pieces vs gblup_from_bed")
        check(rejected, "gblup_from_bed_pieces rejects missing calls")

        # -- (b) the diskstream cell -------------------------------------------------
        n, p, bc = disk
        prefix = Path(tempfile.gettempdir()) / f"gbm_disk_panel_{n}x{p}"
        expect_size = 3 + (n + 3) // 4 * p
        bed = prefix.with_suffix(".bed")
        if not (bed.is_file() and bed.stat().st_size == expect_size):
            t0 = time.perf_counter()
            write_random_bed(prefix, n, p)
            print(f"OOC (b) wrote {bed} ({expect_size / 1e9:.2f} GB) in "
                  f"{time.perf_counter() - t0:.1f} s (host)")
        st = streaming.BedShardStreamer(prefix, block_cols=bc)
        t0 = time.perf_counter()
        host_bytes = sum(P.nbytes for _, _, P in st.iter_payload())
        t_host = time.perf_counter() - t0
        if cuda:
            h2d_line(card)
        y = np.random.default_rng(0).normal(size=n).astype(np.float32)
        timer = StageTimer()
        reset_peak()
        t0 = time.perf_counter()
        gp, resid = streaming.gblup_from_bed_pieces(prefix, y, lam=0.1, block_cols=bc,
                                                    cg_iters=OOC_CG_ITERS, device=dev, timer=timer)
        t_pieces = time.perf_counter() - t0
        peak_p = peak_gib()
        timer_d = StageTimer()
        reset_peak()
        t0 = time.perf_counter()
        gd, Kd = streaming.gblup_from_bed(prefix, y, lam=0.1, block_cols=bc, device=dev,
                                          timer=timer_d)
        gd = gd.cpu().numpy()
        t_dense = time.perf_counter() - t0
        peak_d = peak_gib()
        del Kd
        gap = float(np.abs(gp - gd).max())
        tol = resid + OOC_GEBV_REL * float(np.abs(gd).max())
        print(f"OOC (b) diskstream {n}x{p} block_cols={bc} ({len(st)} shards, {host_bytes / 1e9:.2f} GB "
              f"packed): host-only pass (disk + prefetch) {t_host:.3f} s "
              f"({host_bytes / 1e9 / t_host:.2f} GB/s) {card}")
        print(f"OOC (b) diskstream pieces (packed h2d, card unpack, torch._int_mm pieces, "
              f"{OOC_CG_ITERS} CG it.): {t_pieces:.3f} s, {n * p / t_pieces:.6g} SNPs/s "
              f"({stages(timer)}), resid={resid:.3g}, peak {peak_p:.2f} GiB {card}")
        print(f"OOC (b) diskstream dense (host int8 decode, K1 per shard, Cholesky): {t_dense:.3f} s, "
              f"{n * p / t_dense:.6g} SNPs/s ({stages(timer_d)}), peak {peak_d:.2f} GiB; "
              f"GEBV max|Δ| pieces vs dense {gap:.3g} (tolerance {tol:.3g}) {card}")
        check(bool(np.all(np.isfinite(gp))) and bool(np.all(np.isfinite(gd))),
              "diskstream GEBVs finite")
        check(gap <= tol, "diskstream pieces vs dense GEBVs within the CG residual")
        # One shard resident on the device: what each path's device work costs a shard.
        a, b, payload = next(iter(st.iter_payload()))
        payload = torch.from_numpy(payload).to(dev)
        bounds = pc.make_bounds(n, 4096)
        shard_ms = {}
        if cuda:
            pieces = pc.zero_pieces(n, bounds, device=dev)
            miss = torch.zeros((), dtype=torch.int64, device=dev)
            shard_ms["pieces"] = cuda_ms(
                lambda: pc.accumulate_bed_payload(pieces, payload, miss, bounds=bounds, n=n), reps=2)
            Dsh = pc.unpack_bed_payload(payload, n)[0]
            shard_ms["unpack"] = cuda_ms(lambda: pc.unpack_bed_payload(payload, n), reps=3)
            del pieces
        else:
            Dsh = pc.unpack_bed_payload(payload, n)[0]

        # -- (c) the northstar cell ----------------------------------------------------
        n, p, S = north
        cols = p // S
        gen = torch.Generator(device=dev)

        def shard(k):
            gen.manual_seed(OOC_SEED * 1000 + k)
            return torch.randint(0, 3, (cols, n), dtype=torch.int8, device=dev, generator=gen)

        gen.manual_seed(OOC_SEED)
        yn = torch.randn(n, device=dev, generator=gen)
        bounds = pc.make_bounds(n, 4096)
        timer = StageTimer()
        reset_peak()
        t0 = time.perf_counter()
        with timer.stage("syrk"):
            pieces = pc.zero_pieces(n, bounds, device=dev)
            for k in range(S):
                pc.accumulate_dosage_shard(pieces, shard(k), bounds=bounds)
            sync()
        with timer.stage("center"):
            pieces = pc.center_scale_pieces(pieces, 4.0, bounds=bounds)
            sync()
        with timer.stage("cg"):
            gp, resid = pc.cg_solve_pieces(pieces, yn, 1e-3, bounds=bounds, iters=OOC_CG_ITERS)
            resid = float(resid)
        t_pieces = time.perf_counter() - t0
        peak_p = peak_gib()
        del pieces
        timer_d = StageTimer()
        reset_peak()
        t0 = time.perf_counter()
        with timer_d.stage("k1"):
            acc = None
            for k in range(S):
                L = gram_tri_snp_major(shard(k), 2, device=dev)
                acc = L if acc is None else acc.add_(L)
                del L
            sync()
        with timer_d.stage("center"):
            Kl = acc.to(torch.float32).div_(4.0)
            del acc
            Kl = _center_gram_lower(Kl)
            lam = 1e-3 * float(Kl.diagonal().mean())
        with timer_d.stage("cholesky"):
            gd = gblup_solve_lower(Kl, yn, lam)
            sync()
        t_dense = time.perf_counter() - t0
        peak_d = peak_gib()
        del Kl
        gp, gd = gp.cpu().numpy(), gd.cpu().numpy()
        gap = float(np.abs(gp - gd).max())
        tol = resid + OOC_GEBV_REL * float(np.abs(gd).max())
        print(f"OOC (c) northstar {n}x{p} ({S} int8 shards of {cols} synthesized on the card), "
              f"pieces (4096 wide, torch._int_mm) + center + {OOC_CG_ITERS} CG it. lam_rel=1e-3: "
              f"{t_pieces:.3f} s, {n * p / t_pieces:.6g} SNPs/s ({stages(timer)}), resid={resid:.3g}, "
              f"peak {peak_p:.2f} GiB {card}")
        print(f"OOC (c) northstar dense (K1 per shard, int32 triangles added, scaled and centered "
              f"once, Cholesky): {t_dense:.3f} s, {n * p / t_dense:.6g} SNPs/s ({stages(timer_d)}), "
              f"peak {peak_d:.2f} GiB; GEBV max|Δ| pieces vs dense {gap:.3g} (tolerance "
              f"{tol:.3g}) {card}")
        check(bool(np.all(np.isfinite(gp))) and bool(np.all(np.isfinite(gd))), "northstar GEBVs finite")
        check(gap <= tol, "northstar pieces vs dense GEBVs within the CG residual")

        # -- (d) the command line on the card ---------------------------------------------
        d = work / "cli"
        d.mkdir()
        gbm.write_bed(called, d / "panel")
        gbm.write_phenomes_tsv(phenomes, d / "pheno.tsv")
        geno, pheno = str(d / "panel.bed"), str(d / "pheno.tsv")
        k1 = gbm.LAUNCHES["gram_tri_int8"]
        t0 = time.perf_counter()
        check(cli(["fit", "--geno", geno, "--pheno", pheno, "--model", "gblup",
                   "--out", str(d / "gblup.npz"), "--device", str(dev)]) == 0, "CLI fit gblup")
        check(cli(["predict", "--geno", geno, "--fit", str(d / "gblup.npz"),
                   "--out", str(d / "gebv.tsv"), "--device", str(dev)]) == 0, "CLI predict")
        t_cli = time.perf_counter() - t0
        check(gbm.LAUNCHES["gram_tri_int8"] > k1 or not cuda, "CLI fit gblup launched K1")
        via_cli = np.loadtxt(d / "gebv.tsv", delimiter="\t", skiprows=1, usecols=2)
        gb = gbm.read_bed(d / "panel")
        fit = gbm.gblup(gb, phenomes, idx_trait=0, device=dev)
        api = gbm.predict(fit, gb, list(range(gb.n)), device=dev)
        err_cli = float(np.abs(via_cli - api).max() / np.abs(api).max())
        k2 = gbm.LAUNCHES["gram_tri_float"]
        check(cli(["fit", "--geno", geno, "--pheno", pheno, "--out", str(d / "ridge.npz"),
                   "--device", str(dev)]) == 0, "CLI fit (ridge)")
        check(gbm.LAUNCHES["gram_tri_float"] > k2 or not cuda, "CLI fit ridge launched K2")
        check(cli(["grm", "--geno", geno, "--out", str(d / "grm.npy"), "--device", str(dev)]) == 0,
              "CLI grm")
        check(cli(["grm", "--geno", geno, "--streaming", "--block-cols", str(cli_block_cols),
                   "--out", str(d / "grm_stream.npy"), "--device", str(dev)]) == 0,
              "CLI grm --streaming")
        Km, Ks = np.load(d / "grm.npy"), np.load(d / "grm_stream.npy")
        s = np.trace(Km) / np.trace(Ks)  # VanRaden-scaled in memory, raw centered when streamed
        err_grm = float(np.abs(Km - Ks * s).max() / np.abs(Km).max())
        print(f"OOC (d) CLI on {gb.n}x{gb.p} (phase 6's called panel as .bed): fit gblup + predict "
              f"{t_cli:.3f} s, max|Δ GEBV| vs the Python API {err_cli:.3g} (over max|GEBV|); "
              f"fit ridge ran; grm --streaming (block_cols={cli_block_cols}) vs in memory "
              f"{err_grm:.3g} (over max|K|) {card}")
        check(err_cli <= CLI_TOL and err_grm <= CLI_TOL, "CLI against the Python API")
    finally:
        tmp.cleanup()
    launched = dict(gbm.LAUNCHES)
    print(f"launches in phase 15: {launched}")
    if cuda:
        check(launched["gram_tri_int8"] > 0 and launched["gram_tri_float"] > 0,
              "phase 15 launched K1 and K2")

    # K1 at the cells' shard shapes, after the counts were read: the snp-major
    # shard through `gram_tri_snp_major` (the transposing copy included) and
    # the kernel alone on the padded operand, beside the bound and
    # torch._int_mm of the same operand.
    k1_times = []
    if cuda:
        shards = [("diskstream", Dsh), ("northstar", shard(0))]
        for label, F in shards:
            cols, n = F.shape
            Dp = entry_major(F)
            pp = Dp.shape[1]
            with_copy = cuda_ms(lambda: gram_tri_snp_major(F, 2, device=dev), reps=3)
            ms = cuda_ms(lambda: gram_tri_int8(Dp, 2), reps=3)
            lib_ms = cuda_ms(lambda: torch._int_mm(Dp, Dp.t()), reps=2)
            bound_ms, bound_by = gram_bound(n, pp, "int8", 1)
            k1_times.append(dict(cell=label, shape=f"{n}x{pp}", ms=ms, with_transpose_ms=with_copy,
                                 bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms))
            print(f"K1 {n}x{pp} ({label} shard of {cols} markers, padded): {ms:.3f} ms, bound "
                  f"{bound_ms:.3f} ms ({bound_by}; {bound_ms / ms:.1%} of bound); with the "
                  f"transposing copy {with_copy:.3f} ms; torch._int_mm {lib_ms:.3f} ms "
                  + (f"; pieces path per shard {shard_ms['pieces']:.3f} ms (unpack "
                     f"{shard_ms['unpack']:.3f} ms)" if label == "diskstream" else "") + f" {card}")
            del Dp
        del shards
        torch.cuda.empty_cache()
    return launched, k1_times


# Phase 16: the mesh paths, D thread ranks on this one card over gloo (NCCL
# refuses two ranks on one device), so its times include the host staging of
# every collective and are not interconnect times. Tolerances:
# (a) K1's sharded GRM is exact (bit-equal); K2's within K2_TOL·max|K|;
# (b) the sharded chain's cor(X b, g) within MESH_COR_GAP of phase 7's chain;
# (c) CG after MESH_CG_ITERS iterations against a float64 dense solve:
#     max |Δ GEBV| <= MESH_CG_REL·max|GEBV| (f32 GEMVs; the system K/p + λI
#     has condition number ~3 here, so CG sits at f32 rounding well before);
# (d) ridge/gblup per fold within CV_DUAL_TOL·std(y) of phase 10's CVs,
#     bayesc pooled y_pred cor >= FOLD_CARD_CPU_COR with phase 13's;
# (e) each scan's statistics against phase 11's: cor >= MESH_GWAS_COR[name]
#     (tests/test_torch_gwas.py's limits) and the same argmax marker.
MESH_COR_GAP, MESH_CG_ITERS, MESH_CG_LAM, MESH_CG_REL = 0.05, 100, 0.1, 1e-4
MESH_GWAS_COR = {"gwasols": 0.99999, "gwaslmm": 0.9999, "gwasreml": 0.9999}


def weak_scaling_part(gbm, dev, card: str, weak) -> dict:
    """Phase 16 (h): `scripts/torch_weak_scaling.py` at D = 1 and 2 thread
    ranks on `dev`, n x p_per_device = `weak`, 4 Gibbs sweeps, 10 CG
    iterations; its JSON lines printed, every stage's time finite and
    positive, K1 and K3 launched on every rank. Returns {D: {stage: s}}."""
    import numpy as np
    import torch

    ws = load_script("torch_weak_scaling")
    k0 = dict(gbm.LAUNCHES)
    t0 = time.perf_counter()
    res = ws.run_weak_scaling(device_counts=(1, 2), n=weak[0], p_per_device=weak[1], gibbs_iters=4,
                              cg_iters=10, emit=lambda line: print(f"  {line}"), device=dev)
    k1, k3 = (gbm.LAUNCHES[k] - k0[k] for k in ("gram_tri_int8", "gibbs_group"))
    print(f"mesh (h) weak scaling {weak[0]}x{weak[1]} per rank at D = 1, 2: "
          f"{time.perf_counter() - t0:.3f} s; K1 launches {k1}, K3 launches {k3} {card}")
    check(set(res) == {1, 2} and all(np.isfinite(v) and v > 0 for r in res.values() for v in r.values()),
          "mesh (h): every weak-scaling stage ran")
    if torch.device(dev).type == "cuda":  # a warm-up and a timed GRM on every rank of D = 1 and 2
        check(k1 == 2 * (1 + 2) and k3 > 0, "mesh (h): K1 and K3 launched on each rank")
    return res


def mesh_phase(gbm, dev, card: str, X_big, y_big, g_big, cor_single: float, cv_cvs, fold_cvs,
               gwas_stats, cv_width=(2048, 32_768), epi_cell=(512, 16_384), ranks: int = 2,
               dryrun=(2, 4), parity_quick: bool = False, weak=(2048, 32_768)) -> dict:
    """Phase 16, the multi-device paths (parallel/), `ranks` thread ranks
    on `dev` (`run_ranks`, gloo), with the launch counters set to 0 just
    before it; returns the counts it launched.

    (a) `sharded_grm` on int8 dosages of phase 7's panel (K1 on each rank's
    10,000 x 51,008 shard) against the single-device K1 GRM, bit for bit;
    the same over a one-rank NCCL group; f32 on the cv cell's panel (K2);
    (b) the marker-sharded BayesC chain on phase 7's panel, bs=600,
    sequential, SWEEPS_BIG sweeps: cor(X b, g) against phase 7's chain,
    marker-updates/s, K3 launches;
    (c) `sharded_gblup_cg` on phase 7's panel (f32) against a float64 dense
    solve of the same system;
    (d) `cvbulk_batched(mesh=)` over ridge, gblup (phase 10 (b)'s call) and
    bayesc (phase 13 (b)'s chains) at the cv cell, 3x5 folds;
    (e) gwasols, gwaslmm and gwasreml with `mesh=` at phase 11's gwas cell;
    (f) `transform2(mult, mesh=)` at the epistasis cell, k=1000, against
    mesh=None: the same (row, col) pairs;
    (g) `dryrun_multichip` at each of `dryrun` ranks, and the parity ledger
    on the card, every row passing;
    (h) the weak-scaling harness (`scripts/torch_weak_scaling.py`) at D = 1
    and 2 thread ranks, n x p_per_device = `weak`, 4 Gibbs sweeps and 10 CG
    iterations: its JSON lines, every stage's time finite and positive, K1
    and K3 launched on each rank."""
    import numpy as np
    import torch

    from genomicbreedingmodels_tpu_torch.entry import dryrun_multichip
    from genomicbreedingmodels_tpu_torch.ops.grm import gram_dosage, gram_panel
    from genomicbreedingmodels_tpu_torch.parallel import sharded
    from genomicbreedingmodels_tpu_torch.parallel.mesh import run_ranks
    from genomicbreedingmodels_tpu_torch.parity import run_parity_ledger

    cuda = torch.device(dev).type == "cuda"
    shape = (1, ranks)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def on_ranks(fn, **kw):
        """Every rank's result and the call's wall seconds."""
        sync()
        t0 = time.perf_counter()
        outs = run_ranks(fn, shape=shape, device=dev, **kw)
        sync()
        return outs, time.perf_counter() - t0

    gbm.reset_launches()

    # -- (a) the sharded GRM ---------------------------------------------------------
    n, p = X_big.shape
    D8 = X_big.mul(2.0).to(torch.int8)  # phase 7's dosages
    k0 = gbm.LAUNCHES["gram_tri_int8"]
    sync()
    t0 = time.perf_counter()
    ref = gram_dosage(D8, device=dev)
    sync()
    t_single = time.perf_counter() - t0
    Ks, t = on_ranks(lambda m: sharded.sharded_grm(D8, m))
    equal = [bool(torch.equal(K, ref)) for K in Ks]
    print(f"mesh (a) sharded_grm int8 {n}x{p} over {ranks} ranks (K1 on {n}x{-(-p // ranks)} each): "
          f"bit-equal to the single-device K1 GRM on each rank {equal}; {t:.3f} s (single device "
          f"{t_single:.3f} s); K1 launches {gbm.LAUNCHES['gram_tri_int8'] - k0} {card}")
    check(all(equal), "mesh (a): the int8 sharded GRM equals the single-device GRM")
    del Ks
    if cuda:
        sync()
        t0 = time.perf_counter()
        (K1,) = run_ranks(lambda m: sharded.sharded_grm(D8, m), shape=(1, 1), device=dev,
                          backend="nccl")
        sync()
        t = time.perf_counter() - t0
        print(f"mesh (a) sharded_grm int8 {n}x{p} over one NCCL rank: bit-equal "
              f"{bool(torch.equal(K1, ref))}; {t:.3f} s (group set-up included) {card}")
        check(bool(torch.equal(K1, ref)), "mesh (a): the one-rank NCCL GRM equals the single-device GRM")
        del K1
    del D8, ref
    G_cv, P_cv = cv_cell(gbm, *cv_width)
    F32 = G_cv.allele_frequencies
    ref = gram_panel(F32, device=dev)
    Ks, t = on_ranks(lambda m: sharded.sharded_grm(F32, m))
    scale = float(ref.abs().max())
    errs = [float((K - ref).abs().max()) / scale for K in Ks]
    same = all(torch.equal(K, Ks[0]) for K in Ks)
    print(f"mesh (a) sharded_grm f32 {cv_width[0]}x{cv_width[1]} over {ranks} ranks (K2): max|Δ|/max|K| "
          f"against the single-device GRM {max(errs):.3g}, the same bits on every rank {same}; "
          f"{t:.3f} s {card}")
    check(max(errs) <= K2_TOL and same, "mesh (a): the f32 sharded GRM")
    del Ks, ref
    if cuda:
        torch.cuda.empty_cache()

    # -- (b) the marker-sharded BayesC chain at size ---------------------------------------
    k0 = gbm.LAUNCHES["gibbs_group"]
    outs, t = on_ranks(lambda m: sharded.sharded_gibbs_regression(
        X_big, y_big, m, axis="mp", model="BayesC", n_iter=SWEEPS_BIG, n_burnin=BURN_BIG,
        block_size=BS_BIG, device_schedule="sequential"))
    k3 = gbm.LAUNCHES["gibbs_group"] - k0
    mu, b = outs[0]
    same = all(o[0] == mu and np.array_equal(o[1], b) for o in outs)
    bt = torch.from_numpy(b).to(X_big.device, torch.float32)
    cor = float(torch.corrcoef(torch.stack([X_big @ bt, g_big]))[0, 1])
    print(f"mesh (b) sharded BayesC {n}x{p} bs={BS_BIG} over {ranks} ranks, sequential, {SWEEPS_BIG} "
          f"sweeps: {t:.3f} s, {SWEEPS_BIG * p / t:.6g} marker-updates/s; cor(X b_hat, g_true)="
          f"{cor:.4f} (phase 7's chain {cor_single:.4f}); K3 launches {k3}; the same bits on every "
          f"rank {same} {card}")
    check(same and bool(np.all(np.isfinite(b))) and abs(cor - cor_single) <= MESH_COR_GAP,
          "mesh (b): the sharded chain tracks phase 7's")
    if cuda:
        check(k3 == SWEEPS_BIG * (p // BS_BIG), "mesh (b): K3 once per block and sweep on each rank")
    del bt
    if cuda:
        torch.cuda.empty_cache()

    # -- (c) matrix-free CG against a float64 dense solve ------------------------------------
    yc = (y_big - y_big.mean()).double()
    outs, t = on_ranks(lambda m: sharded.sharded_gblup_cg(
        X_big, y_big, MESH_CG_LAM, m, n_iter=MESH_CG_ITERS, tol=1e-7 * float(yc.norm())))
    gebv = outs[0][1].double()
    same = all(torch.equal(o[1], outs[0][1]) for o in outs)
    Z = X_big.double()
    Z -= Z.mean(0)
    Kd = Z @ Z.T / p
    del Z
    Kd.diagonal().add_(MESH_CG_LAM)
    alpha = torch.cholesky_solve(yc[:, None], torch.linalg.cholesky(Kd))[:, 0]
    Kd.diagonal().sub_(MESH_CG_LAM)
    gebv_ref = Kd @ alpha + y_big.mean().double()
    del Kd
    rel = float((gebv - gebv_ref).abs().max() / gebv_ref.abs().max())
    print(f"mesh (c) sharded_gblup_cg {n}x{p} f32 over {ranks} ranks, lambda={MESH_CG_LAM} on K/p, "
          f"{MESH_CG_ITERS} iterations at most: {t:.3f} s; max|Δ GEBV|/max|GEBV| against the float64 "
          f"dense solve {rel:.3g}; the same bits on every rank {same} {card}")
    check(same and rel <= MESH_CG_REL, "mesh (c): CG against the dense solve")
    del gebv, gebv_ref, alpha, outs
    if cuda:
        torch.cuda.empty_cache()

    # -- (d) cvbulk_batched over the ranks at the cv cell ------------------------------------
    sd = float(np.std(P_cv.phenotypes[:, 0]))
    kw = dict(n_replications=3, n_folds=5, store_effects=False)
    outs, t_dual = on_ranks(lambda m: gbm.cvbulk_batched(G_cv, P_cv, models=("ridge", "gblup"),
                                                         mesh=m, **kw)[0])
    outs_b, t_bayes = on_ranks(lambda m: gbm.cvbulk_batched(
        G_cv, P_cv, models=("bayesc",), mesh=m, mcmc_n_iter=FOLD_SWEEPS, mcmc_n_burnin=FOLD_BURN,
        **kw)[0])
    parts = []
    for model, mine, ref_cvs in (("ridge", outs, cv_cvs), ("gblup", outs, cv_cvs),
                                 ("bayesc", outs_b, fold_cvs)):
        ref_m = [c for c in ref_cvs if c.fit.model == model]
        for rank_cvs in mine:
            got = [c for c in rank_cvs if c.fit.model == model]
            check(keys(got) == keys(ref_m) and len(got) == 15, f"mesh (d) {model}: the same 15 CVs")
        got = [c for c in mine[0] if c.fit.model == model]
        same = all(np.array_equal(a.y_pred, b.y_pred) for rank_cvs in mine[1:]
                   for a, b in zip(got, [c for c in rank_cvs if c.fit.model == model]))
        dmax = max(float(np.abs(a.y_pred - b.y_pred).max()) for a, b in zip(got, ref_m)) / sd
        cor = float(np.corrcoef(np.concatenate([a.y_pred for a in got]),
                                np.concatenate([b.y_pred for b in ref_m]))[0, 1])
        bits = all(np.array_equal(a.y_pred, b.y_pred) for a, b in zip(got, ref_m))
        parts.append(f"{model} max|Δ y_pred|/sd={dmax:.3g} pooled cor={cor:.6f} bit-equal={bits}")
        check(same, f"mesh (d) {model}: the same bits on every rank")
        if model == "bayesc":
            check(cor >= FOLD_CARD_CPU_COR, "mesh (d) bayesc against phase 13")
        else:
            check(dmax <= CV_DUAL_TOL, f"mesh (d) {model} against phase 10")
    print(f"mesh (d) cvbulk_batched {cv_width[0]}x{cv_width[1]} 3x5 folds over {ranks} ranks against "
          f"mesh=None: " + "; ".join(parts) + f"; ridge+gblup {t_dual:.3f} s, bayesc ({FOLD_SWEEPS} "
          f"sweeps) {t_bayes:.3f} s {card}")
    del outs, outs_b, G_cv, P_cv, F32

    # -- (e) the GWAS scans over the ranks at the gwas cell ------------------------------------
    from genomicbreedingmodels_tpu_torch.models import gwas as gwas_mod

    ng, pg = cv_width
    rng = np.random.default_rng(3)  # phase 11 (b)'s panel and trait
    freq = rng.integers(0, 3, size=(ng, pg)).astype(np.float64) / 2.0
    G = gbm.Genomes(entries=np.array([f"e{i:05d}" for i in range(ng)]),
                    populations=np.array(["pop_1"] * ng),
                    loci_alleles=np.array([f"chr1\t{i}\tA|T\tA" for i in range(pg)]),
                    allele_frequencies=freq)
    P = gbm.Phenomes(entries=G.entries, populations=G.populations, traits=np.array(["t"]),
                     phenotypes=rng.normal(size=(ng, 1)))
    gwas_mod._PREP_CACHE.clear()
    parts = []
    for name in GWAS_SCANS:
        outs, t = on_ranks(lambda m: getattr(gbm, name)(G, P, mesh=m).b_hat)
        ref_z = gwas_stats[name]
        same = all(np.array_equal(o, outs[0]) for o in outs)
        cor = float(np.corrcoef(outs[0], ref_z)[0, 1])
        top = int(np.argmax(np.abs(outs[0]))) == int(np.argmax(np.abs(ref_z)))
        parts.append(f"{name} {t:.3f} s ({pg / t:.6g} markers/s) cor={cor:.7f} argmax equal {top}")
        check(same and cor >= MESH_GWAS_COR[name] and top, f"mesh (e) {name} against phase 11")
    gwas_mod._PREP_CACHE.clear()
    print(f"mesh (e) GWAS {ng}x{pg} over {ranks} ranks (prep on each rank, the scan sharded) "
          f"against phase 11: " + "; ".join(parts) + f" {card}")
    del freq, G, P

    # -- (f) transform2's pair rows over the ranks at the epistasis cell -----------------------
    rng = np.random.default_rng(5)  # phase 14 (b)'s panel
    ne, le = epi_cell
    freq = rng.uniform(size=(ne, le))
    G = gbm.Genomes(entries=np.array([f"e{i:05d}" for i in range(ne)]),
                    populations=np.array(["pop_1"] * ne),
                    loci_alleles=np.array([f"chr1\t{i}\tA|T\tA" for i in range(le)]),
                    allele_frequencies=freq)
    yy = freq[:, :32] @ rng.normal(size=32) + rng.normal(size=ne)
    P = gbm.Phenomes(entries=G.entries, populations=G.populations, traits=np.array(["t"]),
                     phenotypes=yy[:, None])
    ref = gbm.transform2(gbm.mult, G, P, n_new_features_per_transformation=1000, device=dev)
    outs, t = on_ranks(lambda m: gbm.transform2(gbm.mult, G, P, n_new_features_per_transformation=1000,
                                                mesh=m))
    same = [set(map(str, o.loci_alleles)) == set(map(str, ref.loci_alleles)) for o in outs]
    print(f"mesh (f) transform2 mult {ne}x{le} k=1000 over {ranks} ranks: {t:.3f} s, "
          f"{le * le / t:.4g} pairs/s; the same {ref.p} pairs as mesh=None on each rank {same} {card}")
    check(all(same) and ref.p > 0, "mesh (f): transform2 keeps mesh=None's pairs")
    del freq, G, P, outs

    # -- (g) the dry run and the parity ledger ----------------------------------------------------
    for d in dryrun:
        sync()
        t0 = time.perf_counter()
        dryrun_multichip(d, device=dev)
        sync()
        print(f"mesh (g) dryrun_multichip({d}) on {dev}: {time.perf_counter() - t0:.3f} s {card}")
    t0 = time.perf_counter()
    rows = run_parity_ledger(emit=lambda s: print(f"  parity {s}"), quick=parity_quick, device=dev)
    print(f"mesh (g) parity ledger on {dev}: {sum(r['pass'] for r in rows)}/{len(rows)} rows pass, "
          f"{time.perf_counter() - t0:.3f} s {card}")
    check(all(r["pass"] for r in rows), "mesh (g): every parity row passes")

    weak_scaling_part(gbm, dev, card, weak)
    launched = dict(gbm.LAUNCHES)
    if cuda:
        check(all(launched[k] > 0 for k in launched), "phase 16 launched K1, K2 and K3")
    return launched


# Phase 17: the JAX package's other Gram schedules, ported as library
# products, against `gram_panel` (K2) within K2_TOL on the raw Gram's scale,
# max|X·Xᵀ|, as K2 is held. A float32 product (cuBLAS, TF32 off) of the
# 2048x32768 cell lies ~3e-6·max|X·Xᵀ| from float64 and centering keeps that
# error while it shrinks the entries ~4x, so a centered Gram is held on the
# raw scale too (its distance over its own max|K| is printed beside it).


def gram_phase(gbm, dev, card: str, width=(2048, 32_768)) -> tuple:
    """Phase 17, with the launch counters set to 0 just before it; returns
    (the counts it launched, {dtype: {schedule: ms}}).

    On a uniform `width` panel in f32 and in bf16: `gram_recursive`,
    `gram_triangular` (centered and raw), `gram_centered_blocked`,
    `gram_centered_device` and `gram_centered_device(use_pallas=True)` (both
    `gram_panel`'s K2), each against `gram_panel`
    (K2; raw or centered alike) and against the float64 Gram, each timed by
    CUDA events on the card."""
    import torch

    from genomicbreedingmodels_tpu_torch.ops import grm

    cuda = torch.device(dev).type == "cuda"
    gbm.reset_launches()
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    times = {}
    for dt in (torch.float32, torch.bfloat16):
        X = torch.rand(width, device=dev, generator=gen).to(dt)
        refs = {True: grm.gram_panel(X, device=dev), False: grm.gram_panel(X, center=False, device=dev)}
        scale = float(refs[False].abs().max())  # max|X·Xᵀ|: K2's hold is on this scale
        Z = X.double()
        exact = {False: Z @ Z.T}
        Z -= Z.mean(0)
        exact[True] = Z @ Z.T
        del Z
        twins = {
            "gram_panel (K2)": (True, lambda: grm.gram_panel(X, device=dev)),
            "gram_recursive": (True, lambda: grm.gram_recursive(X, device=dev)),
            "gram_recursive(center=False)":
                (False, lambda: grm.gram_recursive(X, center=False, device=dev)),
            "gram_triangular": (True, lambda: grm.gram_triangular(X, device=dev)),
            "gram_triangular(center=False)":
                (False, lambda: grm.gram_triangular(X, center=False, device=dev)),
            "gram_centered_blocked": (True, lambda: grm.gram_centered_blocked(X, device=dev)),
            "gram_centered_device": (True, lambda: grm.gram_centered_device(X, device=dev)),
            "gram_centered_device(use_pallas=True)":
                (True, lambda: grm.gram_centered_device(X, use_pallas=True, device=dev)),
        }
        times[str(dt)[6:]] = {}
        parts, bad = [], []
        for name, (center, fn) in twins.items():
            K = fn()
            ref = refs[center]
            d = float((K - ref).abs().max())
            err64 = float((K - exact[center]).abs().max()) / scale
            sym = bool(torch.equal(K, K.T))
            ms = cuda_ms(fn, reps=3) if cuda else float("nan")
            times[str(dt)[6:]][name] = ms
            parts.append(f"{name} {ms:.3f} ms, against gram_panel {d / scale:.3g} (over its own "
                         f"max|K| {d / float(ref.abs().max()):.3g}), against f64 {err64:.3g}, "
                         f"symmetric {sym}")
            # a centered Gram is mirrored by center_gram; a raw one is the products' own
            if not (K.shape == ref.shape and K.dtype == torch.float32 and d <= K2_TOL * scale
                    and (sym or not center)):
                bad.append(name)
            del K
        print(f"Gram schedules {width[0]}x{width[1]} {str(dt)[6:]} (max|Δ| over max|X·Xᵀ|): "
              + "; ".join(parts) + f" {card}")
        check(not bad, f"{bad} {dt} against gram_panel")
        del X, refs, exact
    launched = dict(gbm.LAUNCHES)
    if cuda:
        check(launched["gram_tri_float"] > 0, "phase 17 launched K2")
    return launched, times


# Phase 18: the repaired GRM routes (ROADMAP C.1, C.2) and the port's four
# examples, each run through its main(device=) on the card and again with
# device="cpu" at the same size. Card against CPU: quickstart's ols, ridge
# and gblup held-out cor within EX_COR_TOL, the same CV tags and folds;
# gwasols's top 20 the same but for markers tied (within EX_TIE_TOL of the
# 20th |b|, relative); out-of-core GEBVs within EX_GEBV_TOL·max|GEBV|. The
# multichip example's sharded GRMs against the single-device `gram_auto`:
# float within K2_TOL·max|K|, int8 bit-equal; every rank the same bits.
EXAMPLES = ("torch_quickstart", "torch_gwas_workflow", "torch_out_of_core",
            "torch_multichip_sharding")
EXAMPLE_KERNELS = {  # what each example must launch on the card
    "torch_quickstart": ("gram_tri_float",),
    "torch_gwas_workflow": ("gram_tri_float",),
    "torch_out_of_core": ("gram_tri_int8",),
    "torch_multichip_sharding": ("gram_tri_int8", "gram_tri_float", "gibbs_group"),
}
EX_COR_TOL, EX_TIE_TOL, EX_GEBV_TOL = 1e-3, 1e-4, 1e-4


def _finite(*xs) -> bool:
    import numpy as np

    return all(bool(np.all(np.isfinite(np.asarray(x, dtype=float)))) for x in xs)


def start_cpu_examples(sizes=None, threads: int = 4) -> tuple:
    """Starts phase 18's references: a child process that runs each example's
    main(device="cpu") (at `sizes[name]`, else its own size) with `threads`
    torch threads and pickles (result, wall seconds) per example into a new
    temporary directory. Returns (the process, the directory); the caller
    collects with `cpu_example_results`, and `atexit` ends the child if the
    script stops first."""
    import atexit
    import tempfile
    import textwrap

    out = Path(tempfile.mkdtemp(prefix="chip_smoke_examples_"))
    code = textwrap.dedent(f"""
        import pickle, sys, time
        sys.path.insert(0, {str(Path(__file__).resolve().parent)!r})
        import torch
        torch.set_num_threads({threads})
        import chip_smoke
        for name in chip_smoke.EXAMPLES:
            example = chip_smoke.load_script(name, "examples")
            t0 = time.perf_counter()
            res = example.main(device="cpu", **{sizes or {}!r}.get(name, {{}}))
            with open({str(out)!r} + "/" + name + ".pkl", "wb") as f:
                pickle.dump((res, time.perf_counter() - t0), f)
    """)
    with open(out / "log.txt", "w") as log:
        proc = subprocess.Popen([sys.executable, "-c", code], stdout=log, stderr=subprocess.STDOUT)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, out


def cpu_example_results(proc, out: Path, timeout: float = 600.0) -> dict:
    """Waits for `start_cpu_examples`'s child; returns {name: (result,
    seconds)} and removes its directory. Fails if the child failed."""
    import pickle
    import shutil

    t0 = time.perf_counter()
    rc = proc.wait(timeout=timeout)
    waited = time.perf_counter() - t0
    log = (out / "log.txt").read_text()
    if rc != 0:
        print(log[-3000:])
    check(rc == 0, "the examples' device='cpu' runs (child process)")
    res = {}
    for name in EXAMPLES:
        with open(out / f"{name}.pkl", "rb") as f:
            res[name] = pickle.load(f)
    shutil.rmtree(out, ignore_errors=True)
    print(f"phase 18 (b) the examples' device='cpu' runs (a child process started after the "
          f"build, {len(log.splitlines())} lines of output): waited {waited:.1f} s for it")
    return res


def grm_routes_part(gbm, dev, card: str, D_called, width=(2048, 32_768)) -> dict:
    """Phase 18 (a): `gram_auto` of an int8 tensor of `D_called` takes K1 and
    equals `gram_dosage` bit for bit (C.1); `gram_centered_device`'s default
    on a uniform `width` panel, f32 and bf16, takes K2 and stays within
    K2_TOL·max|X·Xᵀ| of `gram_panel` (C.2), timed beside the library product
    it ran before (one float32 `torch.mm` of the panel cast to float32, then
    `center_gram`). Returns {dtype: (default ms, library product ms)}."""
    import torch

    from genomicbreedingmodels_tpu_torch.ops import grm

    cuda = torch.device(dev).type == "cuda"
    D = torch.from_numpy(D_called).to(dev)
    before = gbm.LAUNCHES["gram_tri_int8"]
    K_auto = grm.gram_auto(D, device=dev)
    k1 = gbm.LAUNCHES["gram_tri_int8"] - before
    equal = torch.equal(K_auto, grm.gram_dosage(D, device=dev))
    print(f"phase 18 (a) gram_auto of an int8 tensor {D.shape[0]}x{D.shape[1]}: bit-equal to "
          f"gram_dosage {equal}, K1 launches {k1}, finite {bool(torch.isfinite(K_auto).all())}")
    check(equal and bool(torch.isfinite(K_auto).all()) and (k1 > 0 or not cuda),
          "gram_auto of an int8 tensor is gram_dosage through K1")
    del D, K_auto
    gen = torch.Generator(device=dev)
    gen.manual_seed(18)
    times = {}
    for dt in (torch.float32, torch.bfloat16):
        X = torch.rand(width, device=dev, generator=gen).to(dt)
        before = gbm.LAUNCHES["gram_tri_float"]
        K = grm.gram_centered_device(X, device=dev)
        k2 = gbm.LAUNCHES["gram_tri_float"] - before
        scale = float(grm.gram_panel(X, center=False, device=dev).abs().max())
        d = float((K - grm.gram_panel(X, device=dev)).abs().max())
        ms = cuda_ms(lambda: grm.gram_centered_device(X, device=dev), reps=5) if cuda else float("nan")
        lib_ms = (cuda_ms(lambda: grm._full_gram(X.float(), center=True), reps=5) if cuda
                  else float("nan"))
        times[str(dt)[6:]] = (ms, lib_ms)
        print(f"phase 18 (a) gram_centered_device {width[0]}x{width[1]} {str(dt)[6:]}: {ms:.3f} ms "
              f"(K2, launches {k2}), the library product it ran before {lib_ms:.3f} ms; against "
              f"gram_panel {d / scale:.3g} of max|X·Xᵀ| {card}")
        check(K.dtype == torch.float32 and d <= K2_TOL * scale and (k2 > 0 or not cuda),
              f"gram_centered_device {dt} is gram_panel through K2")
        del X, K
    return times


def examples_part(gbm, dev, card: str, cpu_runs: dict, sizes=None) -> dict:
    """Phase 18 (b): each example's main(device=dev), held against its
    main(device="cpu") at the same size (`sizes[name]`, else the example's
    own) from `cpu_runs` ({name: (result, seconds)}, as `cpu_example_results`
    gives them); their wall seconds, returned numbers and the checks above.
    Returns {name: {kernel: launches}} of the runs on `dev`."""
    import numpy as np
    import torch

    from genomicbreedingmodels_tpu_torch.ops import grm

    cuda = torch.device(dev).type == "cuda"
    sizes = sizes or {}
    runs, launched, seconds = {}, {}, {}
    for name in EXAMPLES:
        example = load_script(name, "examples")
        snap = dict(gbm.LAUNCHES)
        t0 = time.perf_counter()
        runs[name] = example.main(device=str(dev), **sizes.get(name, {}))
        if cuda:
            torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        launched[name] = {k: gbm.LAUNCHES[k] - snap[k] for k in snap}
        if cuda:
            missing = [k for k in EXAMPLE_KERNELS[name] if launched[name][k] == 0]
            check(not missing, f"{name} launched {EXAMPLE_KERNELS[name]} (not {missing})")
    for name in EXAMPLES:
        print(f"phase 18 (b) {name}: {seconds[name]:.2f} s on {dev}, {cpu_runs[name][1]:.2f} s with "
              f"device='cpu'; launches {launched[name]} {card}")
        runs[name] = (runs[name], cpu_runs[name][0])

    q, qc = runs["torch_quickstart"]
    dcor = {m: abs(q["held_out_cor"][m] - qc["held_out_cor"][m]) for m in ("ols", "ridge", "gblup")}
    same_cv = q["cv_tags"] == qc["cv_tags"] and q["cv_entries"] == qc["cv_entries"]
    print("phase 18 (b) quickstart held-out cor card / cpu: " + ", ".join(
        f"{m} {q['held_out_cor'][m]:.6f} / {qc['held_out_cor'][m]:.6f}" for m in q["held_out_cor"])
        + f"; CV {len(q['cv_tags'])} jobs, same tags and folds {same_cv}, summary "
        f"{q['cv_summary']} / {qc['cv_summary']}")
    check(max(dcor.values()) <= EX_COR_TOL and same_cv
          and _finite(list(q["held_out_cor"].values()), list(q["in_sample_cor"].values()),
                      q["cv_cor"]), f"quickstart card against cpu (held-out cor Δ {dcor})")

    g, gc = runs["torch_gwas_workflow"]
    b_dev, b_cpu = np.abs(g["gwasols"]["b_hat"]), np.abs(gc["gwasols"]["b_hat"])
    kth = np.sort(b_cpu)[-20]
    odd = set(g["gwasols"]["top20"]) ^ set(gc["gwasols"]["top20"])
    ties = all(abs(b_cpu[j] - kth) <= EX_TIE_TOL * kth and abs(b_dev[j] - kth) <= EX_TIE_TOL * kth
               for j in odd)
    print("phase 18 (b) gwas direct / tagging in the top 20, card and cpu: " + ", ".join(
        f"{s} {g[s]['direct']}/{g[s]['tagged']} and {gc[s]['direct']}/{gc[s]['tagged']}" for s in g)
        + f"; gwasols top-20 sets differ in {sorted(odd)} (ties {ties})")
    check(ties and _finite(*(g[s]["b_hat"] for s in g)), "gwasols top 20 card against cpu")

    o, oc = runs["torch_out_of_core"]
    rel = float(np.abs(o["gebv"] - oc["gebv"]).max() / np.abs(oc["gebv"]).max())
    print(f"phase 18 (b) out_of_core: {o['n_shards']} shards, mean diag {o['mean_diag']:.6f}, "
          f"cor(GEBV, y) {o['cor']:.6f} (cpu {oc['cor']:.6f}), GEBVs against cpu max|Δ|/max|GEBV| "
          f"{rel:.3g}")
    check(rel <= EX_GEBV_TOL and _finite(o["gebv"]), "out_of_core GEBVs card against cpu")

    m, mc = runs["torch_multichip_sharding"]
    K1 = grm.gram_auto(m["X"], device=dev).cpu()  # not on the dosage grid: K2
    err = float((torch.from_numpy(m["K"]) - K1).abs().max() / K1.abs().max())
    K8 = grm.gram_auto(torch.from_numpy(m["dosages"]).to(dev), device=dev).cpu()  # int8: K1
    equal8 = torch.equal(torch.from_numpy(m["K_dosage"]), K8)
    print(f"phase 18 (b) multichip ({m['ranks']} ranks): sharded GRM against gram_auto "
          f"max|Δ|/max|K| {err:.3g}, int8 sharded GRM bit-equal {equal8}, ranks equal "
          f"{m['ranks_equal']}, fit cor {m['fit_cor']:.6f} (cpu {mc['fit_cor']:.6f})")
    check(err <= K2_TOL and equal8 and m["ranks_equal"] and mc["ranks_equal"]
          and _finite(m["K"], m["beta"], m["b_hat"], m["fit_cor"]), "multichip sharded paths")
    return launched


def examples_phase(gbm, dev, card: str, D_called, cpu_runs: dict, width=(2048, 32_768),
                   sizes=None) -> tuple:
    """Phase 18, with the launch counters set to 0 just before it: (a) then
    (b) against `cpu_runs`; returns (the counts it launched, (a)'s times,
    (b)'s launches per example)."""
    gbm.reset_launches()
    times = grm_routes_part(gbm, dev, card, D_called, width)
    per_example = examples_part(gbm, dev, card, cpu_runs, sizes)
    return dict(gbm.LAUNCHES), times, per_example


# Phase 19: the port's bench (`bench_torch.py`) in subprocesses, as a user
# runs it. Its headline line's SNPs/s is held within BENCH_HEAD_GAP of phase
# 5's; its children count their own kernel launches (`# <section> launches`).
BENCH_HEAD_GAP = 0.10
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline"}


def bench_launches(stderr: str, section: str, kernels: dict) -> dict:
    """{kernel name: count} from a bench section's `# <section> launches K1=.. K2=.. K3=..`
    note; `kernels` is the bench's {kernel name: K1/K2/K3}."""
    names = {short: name for name, short in kernels.items()}
    for line in stderr.splitlines():
        if line.startswith(f"# {section} launches "):
            pairs = (w.split("=") for w in line.split()[3:3 + len(names)])
            return {names[k]: int(v) for k, v in pairs}
    return dict.fromkeys(kernels, 0)


def bench_phase(card: str, head_snps: float, timeout: float = 300.0) -> dict:
    """Phase 19: `bench_torch.py` run as a user runs it, each in a
    subprocess: (a) `--section headline`: one line of the four keys, its
    SNPs/s within BENCH_HEAD_GAP of phase 5's `head_snps`, exit 0 (its check
    against the plain path passed) and K1 launched; (b) `--section
    linkprobe`: one or two lines of the four keys; (c) `main()` with
    GBM_BENCH_HEADLINE_ONLY=1: exit 0 and the last stdout line the
    headline's. Returns the kernels the children launched."""
    import os

    script = Path(__file__).resolve().parent / "bench_torch.py"
    bench_mod = load_script("bench_torch", ".")
    kernels = bench_mod.KERNELS

    def bench(*args, env=None):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, str(script), *args], capture_output=True, text=True,
                           timeout=timeout, env={**os.environ, **(env or {})})
        lines = r.stdout.strip().splitlines()
        rows = [json.loads(ln) for ln in lines]
        check(all(set(d) == BENCH_KEYS for d in rows), f"bench_torch.py {' '.join(args)}: four-key lines")
        return r, rows, time.perf_counter() - t0

    r, rows, dt = bench("--section", "headline")
    launched = bench_launches(r.stderr, "headline", kernels)
    gap = rows[0]["value"] / head_snps - 1.0 if len(rows) == 1 else float("nan")
    print(f"phase 19 (a) bench_torch.py --section headline: exit {r.returncode}, {len(rows)} line, "
          f"{rows[0]['value'] if rows else float('nan'):.6g} SNPs/s against phase 5's {head_snps:.6g} "
          f"({gap:+.2%}), launches {launched}, {dt:.1f} s {card}")
    check(r.returncode == 0 and len(rows) == 1 and abs(gap) <= BENCH_HEAD_GAP,
          "phase 19 (a): the bench's headline passed its check, within 10 % of phase 5's")
    check(launched["gram_tri_int8"] > 0, "phase 19 (a): the bench's headline launched K1")
    r, rows, dt = bench("--section", "linkprobe")
    print(f"phase 19 (b) bench_torch.py --section linkprobe: exit {r.returncode}, "
          + "; ".join(f"{d['value']:.6g} {d['unit']}" for d in rows) + f", {dt:.1f} s {card}")
    check(r.returncode == 0 and len(rows) in (1, 2), "phase 19 (b): the link probe's lines")
    r, rows, dt = bench(env={"GBM_BENCH_HEADLINE_ONLY": "1"})
    main_launched = bench_launches(r.stderr, "headline", kernels)
    last = rows[-1] if rows else {}
    print(f"phase 19 (c) GBM_BENCH_HEADLINE_ONLY=1 bench_torch.py: exit {r.returncode}, last line "
          f"{json.dumps(last)}, {dt:.1f} s {card}")
    check(r.returncode == 0 and last.get("metric", "").startswith(bench_mod.HEADLINE_METRIC + " (n=")
          and last.get("value", 0) > 0, "phase 19 (c): main()'s last line is the headline's")
    return {k: launched[k] + main_launched[k] for k in launched}


def k2_shape_times(shapes, gen, card: str, phase: str, mm_bf16, bf16_lib: str) -> list:
    """K2 timed by CUDA events at each (dtype, n, p) operand shape it was
    launched at in `phase`, on random panels of that shape, beside its bound,
    its plain version and one library product (`torch.mm`, TF32 off; bf16
    through `mm_bf16`). These launches come after the phase's counts."""
    import torch

    from genomicbreedingmodels_tpu_torch.kernels.gram_tri import gram_tri_float, gram_tri_float_plain

    out = []
    for dt, n, p in shapes:
        X = torch.rand((n, p), device="cuda", generator=gen).to(getattr(torch, dt))
        f32 = dt == "float32"
        ms = cuda_ms(lambda: gram_tri_float(X), reps=20)
        plain_ms = cuda_ms(lambda: gram_tri_float_plain(X), reps=5)
        lib_ms = cuda_ms((lambda: torch.mm(X, X.T)) if f32 else (lambda: mm_bf16(X)), reps=20)
        bound_ms, bound_by = (gram_bound(n, p, "tf32", 4, products=3) if f32
                              else gram_bound(n, p, "bf16", 2))
        out.append(dict(shape=f"{n}x{p}", dtype=dt, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by, library_ms=lib_ms,
                        library="torch.mm(X, X.T), TF32 off" if f32 else bf16_lib))
        print(f"K2 {n}x{p} {dt} (launched in {phase}): {ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}; {bound_ms / ms:.1%} of bound) vs plain (float64) {plain_ms:.4f} ms, "
              f"{out[-1]['library']} {lib_ms:.4f} ms {card}")
        del X
    return out


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
    # Phase 18's device="cpu" references run in a child process from here on,
    # on 4 of the host's cores, beside the card's phases 3-6.
    cpu_examples = start_cpu_examples()

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
    # 4352x24576: 17 row blocks of 256 (two groups of the tile order), 3 marker splits.
    k1_inputs = [(64, 512), (129, 257), (1000, 4099), (4352, 24_576), (n_train, 16_384),
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
    # 2304x32768: 18 row blocks of 128 (two groups of the tile order), 2 marker splits.
    k2_inputs = [(129, 257), (256, 2048), (2048, 32768), (2304, 32768), (n_train, 16_384),
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
    # The fold-batched launch at the cv cell's block (bs=258, K=6) for its 15
    # folds: against 15 single launches and the plain version, then timed with
    # Cb cold beside its bound (15 Cb slabs dominate the bytes) and 15 single
    # launches.
    bs, K, F = 258, 6, K3_FOLDS
    args = k3_fold_inputs(dev, gen, F, bs, K, n_invalid=5)
    k3_errs.append(k3_fold_check(args, K, f"F={F} bs={bs} K={K} last 5 invalid"))
    singles = [[a if i == 4 else a[f].contiguous() for i, a in enumerate(args)] for f in range(F)]
    fold_ms = cuda_ms(lambda: (flush.zero_(), grouped_block_update(*args, K=K)), reps=50) - flush_ms
    singles_ms = cuda_ms(lambda: (flush.zero_(), [grouped_block_update(*a, K=K) for a in singles]),
                         reps=20) - flush_ms
    fold_plain_ms = cuda_ms(lambda: (flush.zero_(), grouped_block_update_plain(*args, K=K)),
                            reps=3) - flush_ms
    nbytes = sum(a.numel() * a.element_size() for a in args) + 3 * F * bs * 4
    fold_bound_ms, fold_bound_by = bound(F * (bs // K) * 2**K * (K**3 / 3 + 2 * K * K), PEAK["f32"],
                                         nbytes)
    print(f"K3 fold-batched F={F} bs={bs} K={K}: {fold_ms:.4f} ms per launch, cold L2 "
          f"({fold_ms / F * 1e3:.2f} us per fold-block), bound {fold_bound_ms * 1e3:.3f} us "
          f"({fold_bound_by}: {F} Cb slabs {F * bs * bs * 4 / 1e6:.2f} MB); {F} single launches "
          f"{singles_ms:.4f} ms; plain {fold_plain_ms:.4f} ms {card}")
    records["gibbs_group"].update(fold_F=F, fold_bs=bs, fold_K=K, fold_ms=fold_ms,
                                  fold_singles_ms=singles_ms, fold_plain_ms=fold_plain_ms,
                                  fold_bound_ms=fold_bound_ms, fold_bound_by=fold_bound_by)
    del flush, args, singles

    # The shapes phases 3-4 held K1 and K2 at; every later phase holds the
    # shapes it launched them at and these did not cover (`hold_launched_shapes`).
    held = {k: set(v) for k, v in _build.LAUNCH_SHAPES.items()}

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
    head_snps = n * p / t  # phase 19 holds the bench's headline line to it
    print(f"headline GRM+GBLUP {n}x{p} int8 (K1 + cholesky, lam={LAM:g}): median {t * 1e3:.3f} ms, "
          f"{n * p / t:.4g} SNPs/s; plain path {t_plain * 1e3:.3f} ms, "
          f"{n * p / t_plain:.4g} SNPs/s {card}")
    del gebv_plain
    Kc, gebv_split, head_stages = headline_split(D, y, t * 1e3, card)
    rel = float((gebv_split - gebv).abs().max() / gebv.abs().max())
    print(f"headline split: GEBVs of the stages against the step's: bit-equal "
          f"{bool(torch.equal(gebv_split, gebv))}, max|Δ|/max|GEBV| {rel:.3g}")
    check(rel <= GEBV_TOL, "headline split: the stages give the step's GEBVs")
    solvers = blocked_solver_lines(Kc, y, gebv_split, card)
    del D, y, gebv, gebv_split, Kc
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
    del beta, bt  # X, y and g_true stay for phase 16 and the profiler pass, the script's last phase
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
        mu, b_e, diag = gbm.gibbs_regression(X_e, y_e, model="BayesC", n_iter=200, n_burnin=50,
                                             seed=2, indicator_update=upd, device=dev)
        t = time.perf_counter() - t0
        s2_mean = float(diag["sigma_e2_trace"][50:].mean())
        chains[upd] = (mu + X_e @ b_e, s2_mean)
        print(f"BayesC 512x4096 200 sweeps, indicator_update={upd!r} -> {diag['update']}: {t:.3f} s, "
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
    hold_launched_shapes(held, gen, "phases 5-9")

    # K3 on the first block of phase 7's chain, with its real Cb, u, s2, sigma_e2
    # and noise (after the counters were read: these launches do not count).
    k3_errs.append(k3_check(first_block[:9], first_block[9], "at-size chain, first block"))
    records["gibbs_group"]["max_abs_err"] = max(k3_errs)

    # -- 10. cross-validation, counters from zero -----------------------------------
    t0 = time.perf_counter()
    cv_launches, cv_seconds, cv_cell_cvs = cv_phase(gbm, dev, card)
    print(f"phase 10: {time.perf_counter() - t0:.1f} s; launches in phase 10: {cv_launches}")
    for name, count in cv_launches.items():
        check(count > 0, f"{name} launched in phase 10")
    hold_launched_shapes(held, gen, "phase 10")

    # -- 11. GWAS and 12. multi-trait, counters from zero for each -------------------
    t0 = time.perf_counter()
    gwas_launches, gwas_cell_stats = gwas_phase(gbm, dev, card, X_big=X)
    print(f"phase 11: {time.perf_counter() - t0:.1f} s; launches in phase 11: {gwas_launches} {card}")
    hold_launched_shapes(held, gen, "phase 11")
    t0 = time.perf_counter()
    mt_launches = multitrait_phase(gbm, dev, card, X, genomes)
    print(f"phase 12: {time.perf_counter() - t0:.1f} s; launches in phase 12: {mt_launches} {card}")
    hold_launched_shapes(held, gen, "phase 12")

    # -- 13. fold-batched Bayesian CV and 14. epistasis, counters from zero for each ----
    t0 = time.perf_counter()
    fold_launches, fold_cell_cvs = fold_phase(gbm, dev, card, cv_seconds["bayesc"])
    print(f"phase 13: {time.perf_counter() - t0:.1f} s; launches in phase 13: {fold_launches} {card}")
    check(fold_launches["gibbs_group"] > 0 and fold_launches["gram_tri_float"] > 0,
          "phase 13 launched K2 and K3")
    hold_launched_shapes(held, gen, "phase 13")
    t0 = time.perf_counter()
    epi_launches = epistasis_phase(gbm, dev, card)
    print(f"phase 14: {time.perf_counter() - t0:.1f} s; launches in phase 14: {epi_launches} "
          f"(the pair scan runs torch products, no hand kernel) {card}")
    hold_launched_shapes(held, gen, "phase 14")

    # -- 15. out-of-core and the command line, counters from zero --------------------
    t0 = time.perf_counter()
    ooc_launches, ooc_k1 = outofcore_phase(gbm, dev, card, called, phenomes)
    print(f"phase 15: {time.perf_counter() - t0:.1f} s; launches in phase 15: {ooc_launches} {card}")
    hold_launched_shapes(held, gen, "phase 15")
    ooc_k2 = k2_shape_times(sorted(_build.LAUNCH_SHAPES["gram_tri_float"]), gen, card, "phase 15",
                            mm_bf16, bf16_lib)

    # -- 16. the mesh paths over thread ranks on this card, counters from zero ------------
    t0 = time.perf_counter()
    mesh_launches = mesh_phase(gbm, dev, card, X, y, g_true, cor_big, cv_cell_cvs, fold_cell_cvs,
                               gwas_cell_stats)
    print(f"phase 16: {time.perf_counter() - t0:.1f} s; launches in phase 16: {mesh_launches} {card}")
    hold_launched_shapes(held, gen, "phase 16")
    del g_true, cv_cell_cvs, fold_cell_cvs, gwas_cell_stats

    # -- 17. the Gram schedules, counters from zero ---------------------------------------
    t0 = time.perf_counter()
    gram_launches, gram_times = gram_phase(gbm, dev, card)
    print(f"phase 17: {time.perf_counter() - t0:.1f} s; launches in phase 17: {gram_launches} {card}")
    hold_launched_shapes(held, gen, "phase 17")

    # -- 18. the repaired GRM routes and the examples, counters from zero -----------------
    t0 = time.perf_counter()
    ex_launches, ex_times, ex_kernels = examples_phase(
        gbm, dev, card, encode_dosage(called.allele_frequencies, ploidy=2),
        cpu_example_results(*cpu_examples))
    print(f"phase 18: {time.perf_counter() - t0:.1f} s; launches in phase 18: {ex_launches}; per "
          f"example: {ex_kernels} {card}")
    for name in ("gram_tri_int8", "gram_tri_float", "gibbs_group"):
        check(ex_launches[name] > 0, f"{name} launched in phase 18")
    hold_launched_shapes(held, gen, "phase 18")

    # -- 19. the port's bench in subprocesses (their launches counted in the children) -------
    t0 = time.perf_counter()
    bench_launched = bench_phase(card, head_snps)
    print(f"phase 19: {time.perf_counter() - t0:.1f} s; launches in phase 19's children: "
          f"{bench_launched} {card}")

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
    for name in ("gram_tri_int8", "gram_tri_float"):  # every shape held against the plain version
        records[name]["held_shapes"] = [f"{dt} {n}x{p}" for dt, n, p in sorted(held[name])]
    records["gibbs_group"]["fold_launches"] = fold_launches["gibbs_group"] + epi_launches["gibbs_group"]
    records["gram_tri_int8"]["phase15_shards"] = ooc_k1
    records["gram_tri_int8"]["phase16_launches"] = mesh_launches["gram_tri_int8"]
    records["gram_tri_float"]["phase16_launches"] = mesh_launches["gram_tri_float"]
    records["gibbs_group"]["phase16_launches"] = mesh_launches["gibbs_group"]
    records["gram_tri_float"]["phase15_shapes"] = ooc_k2
    records["gram_tri_float"]["phase17_launches"] = gram_launches["gram_tri_float"]
    records["gram_tri_float"]["phase17_ms"] = gram_times
    records["gram_tri_float"]["phase18_default_ms"] = ex_times
    for name in sources:
        records[name]["phase19_launches"] = bench_launched[name]
        records[name]["phase18_launches"] = ex_launches[name]
        records[name]["phase18_per_example"] = {ex: c[name] for ex, c in ex_kernels.items()}
    records["gram_tri_int8"]["headline_stages"] = {k: v[0] for k, v in head_stages.items()}
    records["gram_tri_int8"]["solvers"] = solvers
    kernels = [  # launches: phases 5-9, 10, 11, ..., 19, each counted from zero
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(c[name] for c in (launches, cv_launches, gwas_launches, mt_launches,
                                           fold_launches, epi_launches, ooc_launches,
                                           mesh_launches, gram_launches, ex_launches,
                                           bench_launched)),
         **records[name]}
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
