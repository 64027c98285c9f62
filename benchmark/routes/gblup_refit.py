"""Route `gblup_refit`: one client refitting GBLUP.

Each request is a new training set: the panel of request i is panel
i mod R of the R made in set-up, its phenotypes are vector i, and the refit
is the program's Gram (`gram_dosage_lower`, K1, for int8 dosages;
`gram_panel`, K2, for bf16 frequencies), then `gblup_solve_lower`
(cuSOLVER), then the GEBVs read back to the host. With `ahead` 0 (the
default) the loop is closed: the client issues the next request when the
GEBVs are on the host. With `ahead` A > 0 the client queues its refits: it
issues request i, then waits for the GEBVs of request i - A, so the card
never waits on the host's issue; when the window's time is up it issues
nothing more, waits for every GEBV it asked for, and only then reads the
clock. Every input is made on the device from the seed in set-up; nothing is
made on the host in the window.

Traffic keys: `panel` ("int8" or "bf16"), `panels` (R), `ahead` (A, 0 if
absent), `warmup_refits`,
`trace_refits`, `min_refit_s` (sizes the phenotype rows; set under the
least time of the Gram kernel alone, so no window can outrun them: one that
does is an error),
`n_causal`, `h2`, `kernels` (the kernel every refit has to launch) and
`limits` (of the numbers compared).
"""

from __future__ import annotations

import math
import time
from collections import deque
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
        R=R, cap=cap, T=T, sent=deque(), panels=panels, Y=Y, out=out, gram=gram, solve=gblup_solve_lower)
    ctx.marks.append(("inputs", time.perf_counter()))
    for j in range(W):  # every panel through the whole refit: cuSOLVER's first call, the allocator
        _refit(ctx, st, cap + T + j)
    ctx.sync()
    ctx.marks.append(("warm-up", time.perf_counter()))


def _refit(ctx, st, row: int, wait: bool = True) -> None:
    with ctx.span("grm"):
        K = st.gram(st.panels[row % st.R])
    with ctx.span("solve"):
        g = st.solve(K, st.Y[row], st.lam)
    with ctx.span("readback"):
        st.out[row].copy_(g, non_blocking=not wait)


def _issue(ctx, st, row: int):
    """Issue refit `row` without waiting for it; returns a wait for its
    GEBVs on the host."""
    _refit(ctx, st, row, wait=False)
    if ctx.device.type != "cuda":
        return lambda: None
    import torch

    done = torch.cuda.Event()
    done.record()
    return done.synchronize


def window(ctx) -> None:
    """Refits until `--seconds` have passed since the first one started; the
    window ends with the last refit's GEBVs on the host. Every refit issued
    counts, over the time until all of their GEBVs are on the host."""
    st = ctx.state
    ahead = ctx.traffic.get("ahead", 0)
    lat, sent = [], deque()
    t_first = time.perf_counter()
    ctx.setup_s = t_first - ctx.t0
    deadline = t_first + ctx.seconds
    k, t_done = 0, t_first
    while (t_done if not ahead else time.perf_counter()) < deadline:
        if k == st.cap:
            raise RuntimeError(f"the window outran its {st.cap} phenotype rows: min_refit_s is too long")
        t_issue = time.perf_counter()
        if not ahead:
            _refit(ctx, st, k)
            t_done = time.perf_counter()
            lat.append(t_done - t_issue)
        else:
            sent.append((t_issue, _issue(ctx, st, k)))
            while len(sent) > ahead:
                lat.append(_wait(sent.popleft()))
        k += 1
    while sent:
        lat.append(_wait(sent.popleft()))
    t_done = time.perf_counter() if ahead else t_done
    ctx.window = {"seconds": t_done - t_first, "requests": k, "latencies_s": lat,
                  "work": float(k) * st.n * st.p}


def _wait(sent) -> float:
    t_issue, wait = sent
    wait()
    return time.perf_counter() - t_issue


def trace_count(ctx) -> int:
    return ctx.state.T


def traced_request(ctx, j: int) -> None:
    """Refit `cap + j`, queued as the window queues them: the first (the
    profiler's start) and the last are waited for, and with `ahead` every
    one `ahead` places before the newest."""
    st, ahead = ctx.state, ctx.traffic.get("ahead", 0)
    with ctx.span("issue"):
        if not ahead:
            _refit(ctx, st, st.cap + j)
            return
        st.sent.append((0.0, _issue(ctx, st, st.cap + j)))
    last = j == 0 or j == st.T - 1
    while st.sent and (last or len(st.sent) > ahead):
        _wait(st.sent.popleft())


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
