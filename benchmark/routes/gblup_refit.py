"""Route `gblup_refit`: a closed loop of one client refitting GBLUP.

Each request is a new training set: the panel of request i is panel
i mod R of the R made in set-up, its phenotypes are vector i, and the refit
is the program's Gram (`gram_dosage_lower`, K1, for int8 dosages;
`gram_panel`, K2, for bf16 frequencies), then `gblup_solve_lower`
(cuSOLVER), then the GEBVs read back to the host. The client issues the
next request when the GEBVs are on the host. Every input is made on the
device from the seed in set-up; nothing is made on the host in the window.

Traffic keys: `panel` ("int8" or "bf16"), `panels` (R), `warmup_refits`,
`trace_refits`, `min_refit_s` (sizes the phenotype rows; set under the
least time of the Gram kernel alone, so no window can outrun them: one that
does is an error),
`n_causal`, `h2`, `kernels` (the kernel every refit has to launch) and
`limits` (of the numbers compared).
"""

from __future__ import annotations

import math
import time
from types import SimpleNamespace

import harness

KERNEL_NAMES = {"gram_tri_int8": "K1", "gram_tri_float": "K2"}


def _phenotypes(X, rows: int, n_causal: int, h2: float, gen):
    """`rows` phenotype vectors (rows, n) on one panel: h² of the variance
    from `n_causal` loci with normal effects (new for every vector), the
    rest noise."""
    import torch

    n, p = X.shape
    idx = torch.randperm(p, generator=gen, device=X.device)[:n_causal]
    C = X[:, idx].to(torch.float32)
    C -= C.mean(dim=0)
    G = C @ torch.randn((n_causal, rows), generator=gen, device=X.device)
    G = (G - G.mean(dim=0)) / G.std(dim=0)
    E = torch.randn((n, rows), generator=gen, device=X.device)
    return (math.sqrt(h2) * G + math.sqrt(1.0 - h2) * E).T.contiguous()


def setup(ctx) -> None:
    import torch

    from genomicbreedingmodels_tpu_torch.ops.chol import gblup_solve_lower
    from genomicbreedingmodels_tpu_torch.ops.grm import gram_dosage_lower, gram_panel

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    n, p, ploidy = cfg["n_entries"], cfg["n_loci"], cfg["ploidy"]
    R = tr["panels"]
    cap = R * math.ceil((ctx.seconds / tr["min_refit_s"] + 1) / R)  # the window's rows
    T = R * math.ceil(tr["trace_refits"] / R)
    W = tr["warmup_refits"]
    rows = cap + T + R * math.ceil(W / R)
    gen = torch.Generator(device=dev).manual_seed(harness.subseed(ctx.seed, 1))
    with ctx.span("inputs"):
        if tr["panel"] == "int8":
            panels = [torch.randint(0, ploidy + 1, (n, p), dtype=torch.int8, device=dev, generator=gen)
                      for _ in range(R)]

            def gram(X):
                return gram_dosage_lower(X, ploidy=ploidy, device=dev)
        elif tr["panel"] == "bf16":
            panels = [torch.rand((n, p), dtype=torch.bfloat16, device=dev, generator=gen) for _ in range(R)]

            def gram(X):
                return gram_panel(X, device=dev)
        else:
            raise ValueError(f"unknown panel {tr['panel']!r}")
        Y = torch.empty((rows, n), dtype=torch.float32, device=dev)
        per = rows // R
        for r in range(R):
            Y[r::R] = _phenotypes(panels[r], per, tr["n_causal"], tr["h2"], gen)
    out = torch.empty((rows, n), dtype=torch.float32, pin_memory=dev.type == "cuda")
    ctx.state = st = SimpleNamespace(
        n=n, p=p, ploidy=ploidy if tr["panel"] == "int8" else None, lam=cfg["lambda_per_locus"] * p,
        R=R, cap=cap, T=T, panels=panels, Y=Y, out=out, gram=gram, solve=gblup_solve_lower)
    ctx.marks.append(("inputs", time.perf_counter()))
    for j in range(W):  # every panel through the whole refit: cuSOLVER's first call, the allocator
        _refit(ctx, st, cap + T + j)
    ctx.sync()
    ctx.marks.append(("warm-up", time.perf_counter()))


def _refit(ctx, st, row: int, events=None) -> None:
    with ctx.span("grm"):
        if events:
            events[0].record()
        K = st.gram(st.panels[row % st.R])
        if events:
            events[1].record()
    with ctx.span("solve"):
        g = st.solve(K, st.Y[row], st.lam)
        if events:
            events[2].record()
    with ctx.span("readback"):
        st.out[row].copy_(g)


def window(ctx) -> None:
    """Refits until `--seconds` have passed since the first one started; the
    window ends with the last refit's GEBVs on the host."""
    import torch

    st = ctx.state
    timed = ctx.traced and ctx.device.type == "cuda"
    lat, events = [], []
    t_first = time.perf_counter()
    ctx.setup_s = t_first - ctx.t0
    deadline = t_first + ctx.seconds
    k, t_done = 0, t_first
    while t_done < deadline:
        if k == st.cap:
            raise RuntimeError(f"the window outran its {st.cap} phenotype rows: min_refit_s is too long")
        t_issue = time.perf_counter()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)] if timed else None
        _refit(ctx, st, k, ev)
        t_done = time.perf_counter()
        lat.append(t_done - t_issue)
        if ev:
            events.append(ev)
        k += 1
    ctx.window = {"seconds": t_done - t_first, "requests": k, "latencies_s": lat,
                  "work": float(k) * st.n * st.p}
    if events:
        torch.cuda.synchronize(ctx.device)
        ctx.stage_ms["grm"] = [a.elapsed_time(b) for a, b, _ in events]
        ctx.stage_ms["solve"] = [b.elapsed_time(c) for _, b, c in events]


def trace_count(ctx) -> int:
    return ctx.state.T


def traced_request(ctx, j: int) -> None:
    with ctx.span("issue"):
        _refit(ctx, ctx.state, ctx.state.cap + j)


def release(ctx) -> None:
    """The program keeps no state between refits; only the allocator's cache
    is left to free."""


def _window_rows(ctx, st) -> dict[int, list[int]]:
    rows = range(ctx.window["requests"])
    return {r: [row for row in rows if row % st.R == r] for r in range(st.R)}


def check(ctx) -> dict:
    """Every refit of the window against the float64 reference, panel by
    panel; returns {name: (value, limit)}."""
    import torch

    from reference import gblup as ref

    st = ctx.state
    worst, bad = 0.0, 0
    for r, rr in _window_rows(ctx, st).items():
        if not rr:
            continue
        prog = st.out[rr].to(ctx.device)
        bad += int((~torch.isfinite(prog).all(dim=1)).sum())
        g = ref.gap(prog, ref.gebv(st.panels[r], st.Y[rr], st.lam, st.ploidy))
        worst = max(worst, float(torch.nan_to_num(g, nan=float("inf")).max()))
    ctx.failed = bad
    lim = ctx.traffic["limits"]
    checks = {"gebv_gap": (worst, lim["gebv_gap"]), "refits_not_finite": (bad, 0)}
    if ctx.device.type == "cuda":
        for k in ctx.traffic["kernels"]:
            missing = max(0, ctx.window["requests"] - ctx.launches.get(k, 0))
            checks[f"refits_without_{KERNEL_NAMES[k].lower()}"] = (missing, 0)
    return checks


def control(ctx) -> dict:
    """The control's readings on the window's refits: the reference one
    precision below the program's, in the program's place."""
    import torch

    from reference import gblup as ref

    st = ctx.state
    worst = 0.0
    for r, rr in _window_rows(ctx, st).items():
        if not rr:
            continue
        want = ref.gebv(st.panels[r], st.Y[rr], st.lam, st.ploidy)
        g = ref.gap(ref.gebv_control(st.panels[r], st.Y[rr], st.lam, st.ploidy), want)
        worst = max(worst, float(torch.nan_to_num(g, nan=float("inf")).max()))
    return {"gebv_gap": worst}
