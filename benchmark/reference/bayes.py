"""Plain reference of replicated k-fold cross-validation of BayesC by
row-masked Gibbs chains, judged by the chain's own states, and its
lower-precision control.

A chain cannot be compared with a second chain: two chains part ways at the
first Gumbel choice whose top two scores lie nearer than float32's rounding,
and after that they differ by Monte Carlo noise. So the reference judges one
sweep at a time, from the program's own state before it, with the same random
numbers, and the posterior mean from the program's own post-burn-in states
(`CHAIN`: the route hands `solve` those states, and the program's state after
each replayed sweep rides in the records under `chain`).

The semantics held:

- folds and panel: the folds of `cv.py` (one label draw per replication from
  `numpy.random.default_rng(seed)`); fold f trains on its mask m_f. Its panel
  is X centred over its training rows, (X - mu_f) * m_f with mu_f the training
  rows' column means, padded with zero columns to p_pad, so held-out rows are
  zero. n_eff = sum(m_f).
- hyperparameters (BGLR's defaults, `config["prior"]`), taken once from the
  whole panel and y: var_y = var(y, ddof 1), ms_x = the sum of the columns'
  variances (ddof 0); S_b0 = var_y * R2 / ms_x * (df_b + 2) / pi0 and
  S_e0 = var_y * (1 - R2) * (df_e + 2), with df_b = df_e = 5, R2 = 0.5,
  pi0 = 0.5 and prior counts 10. The chain starts from mu_0 = the mean of y
  over the training rows, r_0 = (y - mu_0) * m_f, b_0 = 0, s2e_0 =
  sum(r_0²) / (2 n_eff), every s2b_0 = S_b0 / (df_b - 2) and pi_0 = pi0.
- the block sweep: markers in blocks of bs (the configured block size, at
  most p, rounded up to whole groups of K), each block in groups of K. With
  u = X_bᵀ r at the block's start and C_b = X_bᵀ X_b, group g carries
  v = (u + C_gg b_g - sum over earlier groups h of C_gh d_h) / s2e, d_h the
  change of group h. Each of the 2^K inclusion patterns gamma (bit k of the
  pattern's index is marker k) has P = (C_gg * gamma gammaᵀ) / s2e +
  diag(gamma / s2b + 1 - gamma) = L Lᵀ, W = L⁻¹ masked to gamma, and the
  log-weight const + gumbel + ½‖W v‖², const = n_gamma log pi +
  (n_valid - n_gamma) log(1 - pi) - ½ sum_gamma log s2b - ½ log|P|, and
  -inf where gamma holds a padding marker. The pattern is the arg max; then
  b_g = Wᵀ(W v + eta_g).
- the scalar draws, in order, from the residual r the sweep leaves:
  mu' = mu + sum(r) / n_eff + sqrt(s2e / n_eff) z, r -= (mu' - mu) m_f;
  s2e' = (sum(r²) + S_e0) / chi2(n_eff + df_e); the common
  s2b' = clamp((sum of included b² + S_b0 df_b) / chi2(n_in + df_b),
  1e-10, 1e6); pi' = clamp(g1 / (g1 + g2), 1e-4, 1 - 1e-4) with
  g1 ~ Gamma(pi0 counts + n_in), g2 ~ Gamma((1 - pi0) counts + p - n_in);
  chi2(k) = 2 Gamma(k / 2). After burn-in each sweep's b and mu enter the
  posterior mean.
- the draws of a sweep, in the order `DRAWS` lists, each from the fold's own
  generator (`torch.Generator` on the panel's device: CUDA's Philox gives
  these numbers only there): float32 normals eta (p_pad), float32 uniforms
  U (n_blocks, G, 2^K) clamped in float32 to [1e-12, 1 - 1e-7] whose
  gumbel = -log(-log U), then a float32 normal z, and four float32
  Gamma(alpha) draws (`torch._standard_gamma` of a 0-d alpha).
- predictions: the posterior means b̂ and mu_c of the post-burn-in sweeps,
  the centring undone as the program documents it: y = mu_c + (X - mu_f) b̂ =
  (mu_c - mu_f · b̂) + X b̂, for every entry.

Plain PyTorch in float64 on the device of the panel, TF32 off; it imports
nothing of the program. The replay draws the same random numbers as the
program from the program's generator state, computes the residual from y,
mu and the program's b, and conditions each group on the program's own
earlier groups. The first sweep starts from the reference's own initial
state (with the program's generators), so that the start is held too: b_ref is drawn for the pattern the program chose, and where
the program's pattern is not the reference's arg max by more than `TAU` the
choice counts under `step_flips`.

The control computes the same one precision below the configuration's, in
the program's place from the program's state before each replayed sweep: the
sweep with its own choices in float32, its products and block Grams in TF32,
its pattern tables (W and const) rounded to bfloat16; its posterior stage (the
mean of the program's post-burn-in states and the predictions) in float32
with TF32 products, its metrics in float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .cv import folds as cv_folds
from .cv import metrics, METRICS
from .precision import tf32 as _tf32

MODELS = ("bayesc",)  # the models whose CV records this reference judges
CHAIN = True  # judged by the chain's states: `solve(..., chain=)`, records' `chain`
POOLED = ()
# The reference's margin, in log-weight, above which a program choice that is
# not the reference's arg max counts as a flip: the program's float32 choices
# stray from the arg max by at most 2e-6 on the card, the control's bfloat16
# tables by 0.028 or more on every seed (PERF.md gives the readings).
TAU = 1e-3
# The draws of one sweep in each fold's generator, in order: (name, sampler).
DRAWS = (("eta", "normal"), ("gumbel", "uniform"), ("mu", "normal"), ("sig_e2", "gamma"),
         ("sig_b2", "gamma"), ("pi_in", "gamma"), ("pi_out", "gamma"))


class _Stream:
    """A fold's generator, drawn from in `DRAWS`' order only."""

    def __init__(self, state: torch.Tensor, device: torch.device):
        self.gen = torch.Generator(device=device)
        self.gen.set_state(state.clone())
        self.dev = device
        self.next = 0

    def take(self, name: str, arg):
        want, kind = DRAWS[self.next]
        if name != want:
            raise ValueError(f"draw {name!r} out of order: {want!r} is next")
        self.next = (self.next + 1) % len(DRAWS)
        if kind == "normal":
            return torch.randn(arg, generator=self.gen, device=self.dev)
        if kind == "uniform":
            return torch.rand(arg, generator=self.gen, device=self.dev).clamp_(1e-12, 1.0 - 1e-7)
        alpha = torch.tensor(float(arg), dtype=torch.float32, device=self.dev)
        return torch._standard_gamma(alpha, generator=self.gen)


def _gumbel(u: torch.Tensor, dtype) -> torch.Tensor:
    return -torch.log(-torch.log(u.to(dtype)))


def sizes(config: dict, p: int) -> dict:
    """Block size bs, group size K, groups G a block, p_pad and n_blocks."""
    K = int(config["mcmc_group_size"])
    bs = -(-min(int(config["mcmc_block_size"]), max(8, p)) // K) * K
    p_pad = -(-p // bs) * bs
    return {"bs": bs, "K": K, "G": bs // K, "p_pad": p_pad, "n_blocks": p_pad // bs, "p": p}


def hyper(X: torch.Tensor, y: torch.Tensor, prior: dict) -> dict:
    var_y = float(y.var(correction=1))
    ms_x = max(float(X.var(0, correction=0).sum()), 1e-8)
    r2, df_b, df_e, pi0 = prior["r2"], prior["df_b"], prior["df_e"], prior["pi0"]
    return {"S_b0": var_y * r2 / ms_x * (df_b + 2.0) / pi0, "S_e0": var_y * (1.0 - r2) * (df_e + 2.0),
            "df_b": df_b, "df_e": df_e, "pi0": pi0, "counts": prior["pi_counts"]}


def _patterns(K: int, device) -> torch.Tensor:
    m = torch.arange(1 << K, device=device)
    return ((m[:, None] >> torch.arange(K, device=device)) & 1).to(torch.float64)


def initial(y: torch.Tensor, w: torch.Tensor, h: dict, p_pad: int) -> dict:
    """The initial state (module docstring) of the folds whose training
    masks are w (F, n), in y's dtype."""
    n_eff = w.sum(1)
    mu = (y * w).sum(1) / n_eff
    r = (y - mu[:, None]) * w
    F = w.shape[0]
    return {"b": y.new_zeros((F, p_pad)), "r": r, "s2": y.new_full((F, p_pad), h["S_b0"] / max(h["df_b"] - 2.0, 0.5)),
            "sig_e2": (r * r).sum(1) / n_eff * 0.5, "mu": mu, "pi": y.new_full((F,), h["pi0"])}


def _before(step: dict, y: torch.Tensor, w: torch.Tensor, h: dict, p_pad: int) -> dict:
    """The state a replayed sweep starts from: the program's, or for the
    first sweep the reference's own initial state with the program's
    generators."""
    return step["before"] if step["t"] else {**initial(y, w, h, p_pad), "gens": step["before"]["gens"]}


def _fold_panels(Xp: torch.Tensor, masks: torch.Tensor, bs: int) -> torch.Tensor:
    """Each fold's panel block-major, (F, n_blocks, n, bs), in Xp's dtype."""
    n, p_pad = Xp.shape
    w = masks.to(Xp.dtype)
    Xf = (Xp[None] - ((w @ Xp) / w.sum(1, keepdim=True))[:, None, :]) * w[:, :, None]
    return Xf.view(-1, n, p_pad // bs, bs).permute(0, 2, 1, 3).contiguous()


def tables(Cgg, s2g, valg, sig_e2, pi, patterns):
    """(W, const) of every group and pattern: Cgg (..., K, K), s2g/valg
    (..., K), sig_e2 and pi broadcasting against the leading dims; W
    (..., P, K, K), const (..., P)."""
    M = patterns * valg[..., None, :]  # (..., P, K)
    MM = M[..., :, None] * M[..., None, :]
    eye = torch.eye(M.shape[-1], dtype=Cgg.dtype, device=Cgg.device)
    P = (Cgg / sig_e2[..., None, None])[..., None, :, :] * MM + torch.diag_embed(
        torch.where(M > 0, 1.0 / s2g[..., None, :], 1.0))
    L = torch.linalg.cholesky(P)
    W = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False) * MM
    logdet = 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    n_in = M.sum(-1)
    const = (n_in * torch.log(pi)[..., None] + (valg.sum(-1)[..., None] - n_in) * torch.log1p(-pi)[..., None]
             - 0.5 * (M * torch.log(s2g)[..., None, :]).sum(-1) - 0.5 * logdet)
    bad = (patterns * (1.0 - valg[..., None, :])).sum(-1) > 0
    return W, torch.where(bad, -math.inf, const)


def _scalars(streams, r, b, incl, mu, sig_e2, n_eff, w, h: dict, p: int) -> dict:
    """mu, sig_e2, s2 and pi after a block sweep that left residual r and
    effects b (fold axis first); draws from `streams` in `DRAWS`' order."""
    dt = r.dtype

    def draw(name, args):
        return torch.stack([s.take(name, a) for s, a in zip(streams, args)]).to(dt)

    F = len(streams)
    z = draw("mu", [()] * F)
    mu_new = mu + r.sum(1) / n_eff + torch.sqrt(sig_e2 / n_eff) * z
    r = r - (mu_new - mu)[:, None] * w
    sig_new = ((r * r).sum(1) + h["S_e0"]) / (2.0 * draw("sig_e2", ((h["df_e"] + n_eff) / 2.0).tolist()))
    n_in = incl.sum(1)
    ssb = (b * b * incl).sum(1)
    s2_new = torch.clamp((ssb + h["S_b0"] * h["df_b"]) / (2.0 * draw("sig_b2", ((h["df_b"] + n_in) / 2.0).tolist())),
                         1e-10, 1e6)
    g1 = draw("pi_in", (h["pi0"] * h["counts"] + n_in).tolist())
    g2 = draw("pi_out", ((1.0 - h["pi0"]) * h["counts"] + (p - n_in)).tolist())
    pi_new = torch.clamp(g1 / (g1 + g2), 1e-4, 1.0 - 1e-4)
    return {"mu": mu_new, "sig_e2": sig_new, "s2": s2_new, "pi": pi_new, "r": r}


def _block_noise(streams, sz: dict, dt):
    """The sweep's normals (F, p_pad) and Gumbel draws (F, n_blocks, G, 2^K), in `dt`."""
    eta = torch.stack([s.take("eta", (sz["p_pad"],)) for s in streams]).to(dt)
    u = torch.stack([s.take("gumbel", (sz["n_blocks"], sz["G"], 1 << sz["K"])) for s in streams])
    return eta, _gumbel(u, dt)


def replay(Xf, C, y, w, before: dict, b_after: torch.Tensor, h: dict, sz: dict, valid):
    """One fold's sweep replayed in float64 from the state `before`,
    conditioned on the program's effects `b_after`: (b_ref, the number of
    flips, the largest margin of a program choice that is not the arg max,
    the scalars after the sweep). Xf (n_blocks, n, bs), C (n_blocks, bs, bs)."""
    nb, n, bs = Xf.shape
    K, G = sz["K"], sz["G"]
    dt, dev = torch.float64, Xf.device
    b0, b1 = before["b"].to(dt), b_after.to(dt)
    sig, pi, mu = before["sig_e2"].to(dt), before["pi"].to(dt), before["mu"].to(dt)
    stream = _Stream(before["gens"], dev)
    eta, gum = _block_noise([stream], sz, dt)
    eta, gum = eta[0], gum[0]
    r0 = (y - mu) * w - torch.einsum("knb,kb->n", Xf, b0.view(nb, bs))
    delta = (b1 - b0).view(nb, bs)
    D = torch.einsum("knb,kb->kn", Xf, delta)
    R = r0[None] - (torch.cumsum(D, 0) - D)  # the residual at each block's start
    u = torch.einsum("knb,kn->kb", Xf, R)
    grp = torch.arange(bs, device=dev) // K
    same, lower = grp[:, None] == grp[None, :], grp[:, None] > grp[None, :]
    v = (u + ((C * same) @ b0.view(nb, bs, 1))[..., 0] - ((C * lower) @ delta[..., None])[..., 0]) / sig
    Cgg = C.view(nb, G, K, G, K).diagonal(dim1=1, dim2=3).permute(0, 3, 1, 2)
    pats = _patterns(K, dev)
    W, const = tables(Cgg, before["s2"].to(dt).view(nb, G, K), valid.view(nb, G, K), sig, pi, pats)
    v = v.view(nb, G, 1, K, 1)
    Z = (W @ v)[..., 0]  # (nb, G, P, K)
    score = const + gum + 0.5 * (Z * Z).sum(-1)
    picked = ((b1.view(nb, G, K) != 0).long() << torch.arange(K, device=dev)).sum(-1)  # the program's patterns
    top, best = score.max(-1)
    margin = top - score.gather(-1, picked[..., None])[..., 0]
    off = picked != best
    flips = int((off & (margin > TAU)).sum())
    worst = float(margin[off].max()) if bool(off.any()) else 0.0
    Wm = W.gather(2, picked[..., None, None, None].expand(nb, G, 1, K, K))[:, :, 0]  # (nb, G, K, K)
    zq = (Wm @ v[:, :, 0])[..., 0] + eta.view(nb, G, K)
    b_ref = (Wm.transpose(-1, -2) @ zq[..., None])[..., 0].reshape(-1)
    r1 = (y - mu) * w - torch.einsum("knb,kb->n", Xf, b1.view(nb, bs))
    incl = (b1 != 0).to(dt) * valid
    sc = _scalars([stream], r1[None], b1[None], incl[None], mu[None], sig[None], w.sum()[None], w[None], h, sz["p"])
    return b_ref, flips, worst, {k: v[0] for k, v in sc.items() if k != "r"}


def control_sweep(Xf, C, y, w, before: dict, h: dict, sz: dict, valid, low: bool = True) -> dict:
    """The control's sweep of every fold from the state `before`, with its own
    choices, group after group: float32, TF32 products, pattern tables
    rounded to bfloat16 (`low`), or the reference's own sweep in float64.
    Xf (F, n_blocks, n, bs), C (F, n_blocks, bs, bs) in that precision.
    Returns the state after it (b, r, s2, sig_e2, mu, pi)."""
    F, nb, n, bs = Xf.shape
    K, G = sz["K"], sz["G"]
    dt, dev = (torch.float32 if low else torch.float64), Xf.device
    streams = [_Stream(g, dev) for g in before["gens"]]
    eta, gum = _block_noise(streams, sz, dt)
    sig, pi, mu = before["sig_e2"].to(dt), before["pi"].to(dt), before["mu"].to(dt)
    b, r = before["b"].to(dt).clone(), before["r"].to(dt).clone()
    Cgg = C.view(F, nb, G, K, G, K).diagonal(dim1=2, dim2=4).permute(0, 1, 4, 2, 3)
    pats = _patterns(K, dev).to(dt)
    W, const = tables(Cgg, before["s2"].to(dt).view(F, nb, G, K), valid.to(dt).view(nb, G, K),
                      sig[:, None, None], pi[:, None, None], pats)
    if low:
        W, const = W.bfloat16().to(dt), const.bfloat16().to(dt)
    base = const + gum.view(F, nb, G, -1)
    eta = eta.view(F, nb, G, K)
    incl = torch.zeros_like(b)
    folds = torch.arange(F, device=dev)
    with _tf32(low):
        for k in range(nb):
            sl = slice(k * bs, (k + 1) * bs)
            u = torch.bmm(r[:, None, :], Xf[:, k])[:, 0]
            b_old = b[:, sl].clone()
            vb = (u + (Cgg[:, k] @ b_old.view(F, G, K, 1)).view(F, bs)) / sig[:, None]
            rows = C[:, k] / sig[:, None, None]
            for g in range(G):
                gs = slice(g * K, (g + 1) * K)
                Z = (W[:, k, g] @ vb[:, None, gs, None])[..., 0]
                m = torch.argmax(base[:, k, g] + 0.5 * (Z * Z).sum(-1), 1)
                Wm = W[:, k, g][folds, m]
                bg = (Wm.transpose(1, 2) @ ((Wm @ vb[:, gs, None])[..., 0] + eta[:, k, g])[..., None])[..., 0]
                vb -= ((bg - b_old[:, gs])[:, None, :] @ rows[:, gs, :])[:, 0]
                b[:, k * bs + g * K:k * bs + (g + 1) * K] = bg
                incl[:, k * bs + g * K:k * bs + (g + 1) * K] = pats[m]
            r -= torch.bmm((b[:, sl] - b_old)[:, None, :], Xf[:, k].transpose(1, 2))[:, 0]
    incl = incl * valid
    sc = _scalars(streams, r, b, incl, mu, sig, w.sum(1), w, h, sz["p"])
    return {"b": b, "r": sc["r"], "s2": sc["s2"][:, None].expand_as(b).clone(), "sig_e2": sc["sig_e2"],
            "mu": sc["mu"], "pi": sc["pi"]}


def solve(X: torch.Tensor, y: np.ndarray, seed: int, n_replications: int, n_folds: int, models,
          control: bool = False, config: dict | None = None, chain: dict | None = None) -> dict:
    """The folds, the hyperparameters and, from `chain` ({model: the route's
    chain of one call}, None where it could not be reached), the posterior
    predictions of every fold; with `control`, the control's predictions and
    its sweep from each replayed sweep's state (module docstring)."""
    dev = X.device
    n, p = X.shape
    sz = sizes(config, p)
    folds = cv_folds(seed, n, n_replications, n_folds)
    masks = torch.as_tensor(np.stack([tr for _, _, tr in folds]), device=dev)
    X64 = X.to(torch.float64)
    y64 = torch.as_tensor(np.asarray(y, dtype=np.float64), device=dev)
    sol = {"folds": folds, "sizes": sz, "n_iter": int(config["mcmc_n_iter"]), "chain": {}, "preds": {}}
    c = (chain or {}).get("bayesc")
    if c is None:
        return sol
    Xp = torch.nn.functional.pad(X64, (0, sz["p_pad"] - p))
    F = c["post_b"].shape[1]
    sol.update(X=Xp, y=y64, masks=masks, hyper=hyper(X64, y64, config["prior"]), chain=c)
    if c["post_b"].shape[0] == 0 or F > len(folds) or c["post_b"].shape[2] != sz["p_pad"]:
        return sol
    w = masks[:F].to(torch.float64)
    means = (w @ Xp) / w.sum(1, keepdim=True)
    if not control:
        b_hat = c["post_b"].to(torch.float64).mean(0)
        mu_hat = c["post_mu"].to(torch.float64).mean(0) - (means * b_hat).sum(1)
        preds = mu_hat[:, None] + b_hat @ Xp.T
    else:
        with _tf32(True):
            b_hat = c["post_b"].float().mean(0)
            means32 = means.float()
            mu_hat = c["post_mu"].float().mean(0) - (b_hat[:, None, :] @ means32[:, :, None])[:, 0, 0]
            preds = mu_hat[:, None] + b_hat @ Xp.float().T
            valid = (torch.arange(sz["p_pad"], device=dev) < p).float()
            Xf = _fold_panels(Xp.float(), masks[:F], sz["bs"])
            C = Xf.transpose(-1, -2) @ Xf
            y32, w32 = y64.float(), w.float()
            sol["after"] = [control_sweep(Xf, C, y32, w32, _before(step, y32, w32, sol["hyper"], sz["p_pad"]),
                                          sol["hyper"], sz, valid) for step in c["steps"]]
            del Xf, C
    sol["preds"] = {f: preds[f].double().cpu().numpy() for f in range(F)}
    return sol


def records_of_control(sol: dict, y: np.ndarray) -> list[dict]:
    """The control's predictions and sweeps as CV records, its metrics in
    float32, for `compare`."""
    chain = None
    if "after" in sol:
        c = sol["chain"]
        chain = {"n_sweeps": sol["n_iter"], "steps": [{"t": s["t"], "after": a} for s, a in zip(c["steps"], sol["after"])]}
    recs = []
    for f, (rep, fold, tr) in enumerate(sol["folds"]):
        if f not in sol["preds"]:
            continue
        pred = sol["preds"][f]
        recs.append({"rep": rep, "fold": fold, "model": "bayesc", "train": np.flatnonzero(tr),
                     "val": np.flatnonzero(~tr), "lam": None, "pred_train": pred[tr], "pred_val": pred[~tr],
                     "y_val": y[~tr], "metrics_val": metrics(y[~tr], pred[~tr], np.float32),
                     "metrics_train": metrics(y[tr], pred[tr], np.float32), "chain": chain})
    return recs


def step_readings(sol: dict, after_steps: list[dict]) -> dict:
    """step_b_gap, step_flips and step_scalar_gap of the replayed sweeps
    (see `compare`), and `flip_margin`: the largest reference margin of a
    program choice that is not the arg max, what `TAU` is set above."""
    c, sz = sol["chain"], sol["sizes"]
    dev = sol["X"].device
    valid = (torch.arange(sz["p_pad"], device=dev) < sz["p"]).to(torch.float64)
    F = c["post_b"].shape[1]
    w_all = sol["masks"][:F].to(torch.float64)
    starts = [_before(step, sol["y"], w_all, sol["hyper"], sz["p_pad"]) for step in c["steps"]]
    gap = flips = scal = worst = 0.0
    for f in range(F):
        w = sol["masks"][f].to(torch.float64)
        Xf = _fold_panels(sol["X"], sol["masks"][f:f + 1], sz["bs"])[0]
        C = Xf.transpose(-1, -2) @ Xf
        for start, after in zip(starts, after_steps):
            before = {k: v[f] for k, v in start.items()}
            b_ref, nf, marg, sc = replay(Xf, C, sol["y"], w, before, after["b"][f], sol["hyper"], sz, valid)
            b1 = after["b"][f].to(torch.float64)
            gap = max(gap, float((b1 - b_ref).abs().max()) / max(float(b_ref.abs().max()), 1e-300))
            flips += nf
            worst = max(worst, marg)
            scale = {"mu": math.sqrt(float(sc["sig_e2"])), "sig_e2": float(sc["sig_e2"]),
                     "s2": float(sc["s2"]), "pi": float(sc["pi"])}
            for k, s in scale.items():
                prog = float(after[k][f] if after[k].dim() == 1 else after[k][f, 0])
                scal = max(scal, abs(prog - float(sc[k])) / s)
        del Xf, C
    return {"step_b_gap": gap, "step_flips": float(flips), "step_scalar_gap": scal, "flip_margin": worst}


def compare(records: list[dict], ref: dict, y: np.ndarray) -> dict:
    """The numbers compared, of one call's BayesC records against the reference:

    - records_differ: records missing, extra, or whose training or
      validation entries or observed values differ from the reference's fold;
    - metric_gap: the widest gap of a reported metric from the metric of the
      record's own predictions, over max(1, |metric|);
    - posterior_pred_gap: the widest gap of a record's prediction (training
      and validation entries) from mu_ref + X b_ref, over std(y), b_ref the
      float64 mean of the program's states after the configured post-burn-in
      sweeps; inf for a fold without states;
    - sweeps_differ: sweeps the chain ran less the configured number, in
      magnitude;
    - step_b_gap: over the replayed sweeps and folds, max |b - b_ref| /
      max |b_ref|, b_ref drawn for the pattern the program chose (the first
      sweep from the reference's own start);
    - step_flips: choices where the program's pattern is not the reference's
      arg max by a margin above TAU;
    - step_scalar_gap: mu (over sqrt(s2e)), s2e, the common s2b and pi after
      the sweep, each as a gap relative to the reference's.
    Without the chain (the route could not reach it) only the first two.
    """
    sd = float(np.std(y, ddof=1))
    index = {(rep, fold): (f, tr) for f, (rep, fold, tr) in enumerate(ref["folds"])}
    seen = set()
    differ = mgap = pgap = 0.0
    chain_out = None
    for r in records:
        key = (r["rep"], r["fold"])
        if key not in index or key in seen or r["model"] != "bayesc":
            differ += 1
            continue
        seen.add(key)
        f, tr = index[key]
        if (not np.array_equal(r["train"], np.flatnonzero(tr)) or not np.array_equal(r["val"], np.flatnonzero(~tr))
                or not np.array_equal(np.asarray(r["y_val"], dtype=np.float64), y[~tr])):
            differ += 1
            continue
        chain_out = r.get("chain") or chain_out
        if f in ref["preds"]:
            want = ref["preds"][f]
            pgap = max(pgap, float(np.abs(r["pred_train"] - want[tr]).max()) / sd,
                       float(np.abs(r["pred_val"] - want[~tr]).max()) / sd)
        else:
            pgap = math.inf
        for part, yy, pp in (("metrics_val", y[~tr], r["pred_val"]), ("metrics_train", y[tr], r["pred_train"])):
            want_m = metrics(yy, pp)
            for m in METRICS:
                mgap = max(mgap, abs(r[part][m] - want_m[m]) / max(1.0, abs(want_m[m])))
    differ += len(set(index) - seen)
    out = {"records_differ": differ, "metric_gap": mgap}
    c = ref["chain"]
    if not c:
        return out
    out["posterior_pred_gap"] = pgap
    n_run = chain_out["n_sweeps"] if chain_out else 0
    out["sweeps_differ"] = float(abs(n_run - ref["n_iter"]))
    steps = chain_out["steps"] if chain_out else []
    if (len(steps) != len(c["steps"]) or not c["steps"] or c["post_b"].shape[2] != ref["sizes"]["p_pad"]
            or any(s["t"] != t["t"] for s, t in zip(steps, c["steps"]))):
        out.update(step_b_gap=math.inf, step_flips=math.inf, step_scalar_gap=math.inf)
        return out
    nums = step_readings(ref, [s["after"] for s in steps])
    nums.pop("flip_margin")
    out.update(nums)
    return out
