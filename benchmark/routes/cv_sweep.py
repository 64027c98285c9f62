"""Route `cv_sweep`: a closed loop of whole `cvbulk_batched` calls.

One host panel, made on the device from the seed in set-up and held as the
program's `Genomes`; every call gets a new trait (1 % causal loci with
normal effects, h² ≈ 0.5, as `bench_torch.py:cv_inputs` makes it), made in
set-up, and its own fold seed, as a breeder runs CV trait by trait on one
genotyped population. The program caches the panel and its Gram on the
device after the first call, so the warm-up pays them.

Config keys: `n_entries`, `n_loci`, `models` (any of `cvbulk_batched`'s),
`n_replications`, `n_folds`, and for the Bayesian models, where given, the
chain's `mcmc_n_iter` and `mcmc_n_burnin` (without them the program's own).
Each model's records are compared with the plain reference under
`reference/` that names the model in its `MODELS` (`harness.references`).
A reference that declares `CHAIN` judges a Gibbs chain by its states: for
each checked call the route re-runs the call with that model alone, the
program's chain driven in one-sweep segments (`_rerun`), and hands the
reference the states it conditions on and the records the program's own
states after the replayed sweeps (`reference/__init__.py`).
Traffic keys: `warmup_calls`, `trace_calls`, `min_call_s` (sizes the traits
made in set-up: a window that outruns them reuses traits), `check_calls`
(calls of the window compared with the reference, drawn from the seed),
`causal_share`, and `limits` of the numbers compared.
"""

from __future__ import annotations

import math
import struct
import time
from types import SimpleNamespace

import numpy as np

import harness

CHAIN_KEYS = ("mcmc_n_iter", "mcmc_n_burnin")  # configuration keys passed on to cvbulk_batched as given
# The program's chain state, positionally (models/bayesian.py:_initial_state),
# and the fields of it a chain reference reads.
STATE_FIELDS = ("b", "r", "s2", "sig_e2", "mu", "pi", "scale", "gens", "acc_b", "acc_mu", "acc_n", "z", "gam")
HANDED = ("b", "r", "s2", "sig_e2", "mu", "pi", "gens")


def _panel(freq: np.ndarray):
    """The program's Genomes of an (n, p) frequency panel, and its Phenomes
    of one trait vector."""
    import genomicbreedingmodels_tpu_torch as gbm

    n, p = freq.shape
    genomes = gbm.Genomes(entries=np.array([f"e{i:05d}" for i in range(n)]),
                          populations=np.array(["pop_1"] * n),
                          loci_alleles=np.array([f"chr1\t{i}\tA|T\tA" for i in range(p)]),
                          allele_frequencies=freq)

    def phenomes(y):
        return gbm.Phenomes(entries=genomes.entries, populations=genomes.populations,
                            traits=np.array(["t"]), phenotypes=np.asarray(y).reshape(n, 1))

    return genomes, phenomes


def setup(ctx) -> None:
    import importlib

    import torch

    batched = importlib.import_module("genomicbreedingmodels_tpu_torch.cv.batched")
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    n, p = cfg["n_entries"], cfg["n_loci"]
    cap = math.ceil(ctx.seconds / tr["min_call_s"]) + 1
    calls = cap + tr["trace_calls"] + tr["warmup_calls"]
    gen = torch.Generator(device=dev).manual_seed(harness.subseed(ctx.seed, 1))
    with ctx.span("inputs"):
        X = torch.rand((n, p), dtype=torch.float32, device=dev, generator=gen)
        B = torch.randn((p, calls), device=dev, generator=gen)
        B *= torch.rand((p, calls), device=dev, generator=gen) < tr["causal_share"]
        G = X.double() @ B.double()
        Y = G + torch.randn((n, calls), dtype=torch.float64, device=dev, generator=gen) * G.std(dim=0)
        freq = X.cpu().numpy()
        traits = Y.T.cpu().numpy()
    genomes, phenomes = _panel(freq)
    ctx.state = st = SimpleNamespace(
        X=X, traits=traits, genomes=genomes, phenomes=[phenomes(y) for y in traits], cap=cap,
        fold_seeds=[harness.subseed(ctx.seed, 2, i) for i in range(calls)], batched=batched,
        kw=dict(models=tuple(cfg["models"]), n_replications=cfg["n_replications"], n_folds=cfg["n_folds"],
                store_effects=False, device=dev, **{k: cfg[k] for k in CHAIN_KEYS if k in cfg}),
        fits=len(cfg["models"]) * cfg["n_replications"] * cfg["n_folds"], results=[], chains={})
    ctx.marks.append(("inputs", time.perf_counter()))
    for j in range(tr["warmup_calls"]):  # the first call uploads the panel and makes its Gram
        _call(ctx, st, cap + tr["trace_calls"] + j)
    ctx.marks.append(("warm-up", time.perf_counter()))


def _call(ctx, st, i: int):
    with ctx.span("cv_call"):
        cvs, _ = st.batched.cvbulk_batched(st.genomes, st.phenomes[i], seed=st.fold_seeds[i], **st.kw)
    return cvs


def window(ctx) -> None:
    """Calls until `--seconds` have passed since the first one started; the
    window ends with the last call's return (its records are host objects)."""
    st = ctx.state
    lat, ctx.stages = [], []
    t_first = time.perf_counter()
    ctx.setup_s = t_first - ctx.t0
    deadline = t_first + ctx.seconds
    k, t_done, fits = 0, t_first, 0
    while t_done < deadline:
        t_issue = time.perf_counter()
        i = k % st.cap
        cvs = _call(ctx, st, i)
        t_done = time.perf_counter()
        lat.append(t_done - t_issue)
        ctx.stages.append({s: v["total_s"] for s, v in st.batched.LAST_TIMER.summary().items()})
        st.results.append((i, cvs))
        fits += len(cvs)
        k += 1
    ctx.window = {"seconds": t_done - t_first, "requests": k, "latencies_s": lat, "work": float(fits)}
    ctx.failed = sum(st.fits - len(cvs) + sum(not np.isfinite(list(cv.metrics.values())).all() for cv in cvs)
                     for _, cvs in st.results)
    if k > st.cap:
        harness.note(f"# the window's {k} calls outran its {st.cap} traits: traits were reused")
    rows = [("call", lat)] + [(s, [c.get(s, 0.0) for c in ctx.stages]) for s in sorted({s for c in ctx.stages for s in c})]
    harness.note("# seconds a call, least / median / most: " + "; ".join(
        f"{s} {min(v):.4f} / {float(np.median(v)):.4f} / {max(v):.4f}" for s, v in rows))


def trace_count(ctx) -> int:
    return ctx.traffic["trace_calls"]


def traced_request(ctx, j: int) -> None:
    _call(ctx, ctx.state, ctx.state.cap + j)


def release(ctx) -> None:
    """Drop the program's device cache of the panel and its Gram."""
    ctx.state.batched._PANEL_CACHE.clear()


def records(cvs) -> list[dict]:
    """The program's CV records in the reference's terms (rows by entry name;
    `lam` None where the model chose no λ, as a Gibbs chain)."""
    def rows(entries):
        return np.array(sorted(int(e[1:]) for e in entries), dtype=np.int64)

    def lam(cv):
        v = cv.fit.extras.get("lambda")
        return None if v is None else float(v)

    return [{"rep": cv.replication, "fold": cv.fold, "model": cv.fit.model, "train": rows(cv.fit.entries),
             "val": rows(cv.validation_entries), "lam": lam(cv),
             "pred_train": np.asarray(cv.fit.y_pred, dtype=np.float64),
             "pred_val": np.asarray(cv.y_pred, dtype=np.float64), "y_val": np.asarray(cv.y_true),
             "metrics_val": cv.metrics, "metrics_train": cv.fit.metrics} for cv in cvs]


def _checked_calls(ctx) -> list[tuple[int, list]]:
    """(trait, records) of the window's calls compared with the reference,
    drawn from the seed."""
    done = ctx.state.results
    rng = np.random.default_rng(harness.subseed(ctx.seed, 3))
    pick = rng.choice(len(done), size=min(ctx.traffic["check_calls"], len(done)), replace=False)
    return [done[j] for j in sorted(pick)]


def _picked_sweeps(ctx, i: int, burnin: int, n_iter: int) -> set[int]:
    """The sweeps of call i's chain that the reference replays: the first,
    which the reference starts from its own initial state, and two drawn
    from the seed, one in burn-in and one after it."""
    rng = np.random.default_rng(harness.subseed(ctx.seed, 4, i))
    picks = {0, int(rng.integers(0, burnin))} if burnin > 0 else {0}
    return picks | ({int(rng.integers(burnin, n_iter))} if n_iter > burnin else set())


def _named(state) -> dict:
    return {k: state[STATE_FIELDS.index(k)] for k in HANDED}


def _rerun(ctx, i: int, model: str):
    """Call i re-run with `model` alone, the program's `_gibbs_chain` driven
    in one-sweep segments through `iters`, `state_in` and `return_state`
    (one long run and chained segments give the same chain, bit for bit).
    Returns (the chain's record, the re-run's records), or None where the
    chain cannot be reached: the private name gone, or not called exactly
    once by the call."""
    import importlib
    import inspect

    import torch

    st, cfg = ctx.state, ctx.config
    try:
        bayesian = importlib.import_module("genomicbreedingmodels_tpu_torch.models.bayesian")
        inner = bayesian._gibbs_chain
        sig = inspect.signature(inner)
    except (ImportError, AttributeError, TypeError, ValueError):
        return None
    if not {"n_iter", "n_burnin", "iters", "state_in", "return_state"} <= set(sig.parameters):
        return None
    runs = []

    def segmented(*args, **kw):
        ba = sig.bind(*args, **kw)
        ba.apply_defaults()
        a = dict(ba.arguments)
        iters = list(range(int(a["n_iter"])) if a["iters"] is None else a["iters"])
        if not iters:
            return inner(*args, **kw)
        burnin = int(cfg.get("mcmc_n_burnin", a["n_burnin"]))
        picks = _picked_sweeps(ctx, i, burnin, int(cfg.get("mcmc_n_iter", a["n_iter"])))
        rec = {"n_sweeps": 0, "steps": [], "post_b": [], "post_mu": []}
        state = a["state_in"]
        if state is None:  # the initial state, generator states with it
            state = inner(**{**a, "iters": range(0), "return_state": True})[3]
        traces = []
        for t in iters:
            before = state
            out = inner(**{**a, "iters": range(t, t + 1), "state_in": before, "return_state": True})
            state = out[3]
            traces.append(out[2])
            rec["n_sweeps"] += 1
            if t in picks:
                rec["steps"].append({"t": t, "before": _named(before), "after": _named(state)})
            if t >= burnin:
                rec["post_b"].append(state[0])
                rec["post_mu"].append(state[4])
        b = state[0]
        rec["post_b"] = torch.stack(rec["post_b"]) if rec["post_b"] else b.new_zeros((0, *b.shape))
        rec["post_mu"] = torch.stack(rec["post_mu"]) if rec["post_mu"] else b.new_zeros((0, b.shape[0]))
        runs.append(rec)
        res = (out[0], out[1], tuple(torch.cat([tr[j] for tr in traces]) for j in range(len(traces[0]))))
        return res + (state,) if a["return_state"] else res

    bayesian._gibbs_chain = segmented
    try:
        cvs, _ = st.batched.cvbulk_batched(st.genomes, st.phenomes[i], seed=st.fold_seeds[i],
                                           **{**st.kw, "models": (model,)})
    finally:
        bayesian._gibbs_chain = inner
        st.batched._PANEL_CACHE.clear()
    return (runs[0], records(cvs)) if len(runs) == 1 else None


def _bits(v):
    """A value's bits, for an exact comparison (NaN equal to itself)."""
    if isinstance(v, dict):
        return tuple((k, _bits(x)) for k, x in v.items())
    if isinstance(v, np.ndarray):
        return v.dtype.str, v.shape, v.tobytes()
    if isinstance(v, float):
        return struct.pack("<d", v)
    return v


def _differ(mine: list[dict], again: list[dict]) -> int:
    """Records of `mine` and `again` that are not the same bit for bit, or
    that one of them lacks."""
    a = {(r["rep"], r["fold"], r["model"]): _bits(r) for r in mine}
    b = {(r["rep"], r["fold"], r["model"]): _bits(r) for r in again}
    return len(set(a) ^ set(b)) + sum(a[k] != b[k] for k in set(a) & set(b)) + len(mine) - len(a)


def _chains(ctx, i: int, models, mine: list[dict]):
    """({model: what its reference conditions on}, {model: the program's
    states after the replayed sweeps}, {rerun_differs, chain_unreachable})
    of call i, its re-runs kept for the control."""
    cond, outs, nums = {}, {}, {"rerun_differs": 0.0, "chain_unreachable": 0.0}
    for m in models:
        key = (i, m)
        if key not in ctx.state.chains:
            ctx.state.chains[key] = _rerun(ctx, i, m)
        got = ctx.state.chains[key]
        if got is None:
            cond[m] = None
            nums["chain_unreachable"] += 1
            continue
        rec, again = got
        nums["rerun_differs"] += _differ([r for r in mine if r["model"] == m], again)
        cond[m] = {"steps": [{"t": s["t"], "before": s["before"]} for s in rec["steps"]],
                   "post_b": rec["post_b"], "post_mu": rec["post_mu"]}
        outs[m] = {"n_sweeps": rec["n_sweeps"], "steps": [{"t": s["t"], "after": s["after"]} for s in rec["steps"]]}
    return cond, outs, nums


def _readings(ctx, control: bool) -> dict:
    """Each number of the checked calls: the worst over the calls, or the
    mean of a number its reference pools. The records of each reference's
    models go to that reference; a configured model that no reference holds
    counts its records, or 1 where it has none, under `records_differ`. A
    chain reference (`CHAIN`) also gets the chain's states (`_chains`), and
    the call counts `rerun_differs` and `chain_unreachable`."""
    st, cfg = ctx.state, ctx.config
    refs = harness.references(cfg["models"])
    groups: dict = {}
    for m in cfg["models"]:
        if m in refs:
            groups.setdefault(refs[m], []).append(m)
    pooled = {k for ref in groups for k in ref.POOLED}
    per_call: dict[str, list[float]] = {}
    for i, cvs in _checked_calls(ctx):
        y = st.traits[i]
        recs = records(cvs)
        nums = {"records_differ": 0.0}
        for ref, models in groups.items():
            args = (st.X, y, st.fold_seeds[i], cfg["n_replications"], cfg["n_folds"], models)
            mine = [r for r in recs if r["model"] in models]
            kw = {"config": cfg}
            if getattr(ref, "CHAIN", False):
                kw["chain"], outs, extra = _chains(ctx, i, models, mine)
                for k, v in extra.items():
                    nums[k] = nums.get(k, 0.0) + v
                mine = [{**r, "chain": outs.get(r["model"])} for r in mine]
            sol = ref.solve(*args, **kw)
            if control:
                mine = ref.records_of_control(ref.solve(*args, control=True, **kw), y)
            for k, v in ref.compare(mine, sol, y).items():
                if k == "records_differ":
                    nums[k] += v
                else:
                    nums[k] = _worst([nums[k], v]) if k in nums else v
        for m in cfg["models"]:
            if m not in refs:
                nums["records_differ"] += max(1, sum(r["model"] == m for r in recs))
        nums["records_differ"] += sum(r["model"] not in cfg["models"] for r in recs)
        for k, v in nums.items():
            per_call.setdefault(k, []).append(v)
    return {k: (sum(v) / len(v) if k in pooled else _worst(v)) for k, v in per_call.items()}


def _worst(values) -> float:
    """The largest of the values, or NaN where one is NaN (`max` may pass one over)."""
    return float("nan") if any(math.isnan(v) for v in values) else max(values)


def check(ctx) -> dict:
    """`check_calls` calls of the window, drawn from the seed, against the
    float64 reference; returns {name: (value, limit)}: the worst of each
    number over the calls compared, or the mean of a pooled one."""
    lim = ctx.traffic["limits"]
    return {k: (v, lim[k]) for k, v in _readings(ctx, control=False).items()}


def control(ctx) -> dict:
    """The control's readings on the same calls: the reference one precision
    below the configuration's, in the program's place."""
    return _readings(ctx, control=True)
