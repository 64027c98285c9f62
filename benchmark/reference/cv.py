"""Plain reference of replicated k-fold cross-validation of ridge, GBLUP and
the lasso, and its lower-precision control.

The semantics held (the CV records the program emits are judged by them):

- folds: per replication one draw of labels in 1..folds for every entry,
  `numpy.random.default_rng(seed).integers(1, folds + 1, size=n)`, one
  stream over the replications; fold j trains on the entries labelled
  other than j and validates on those labelled j.
- ridge and GBLUP: the dual solve on the panel Z centered over every entry,
  K = Z Zᵀ. Fold f: γ = (K_tt + δ I)⁻¹ (y_t - ȳ_t) on its training rows t,
  predictions ȳ_t + K_·t γ for every entry. Ridge: δ = λ·n_t over the λ
  grid, chosen by training GCV, (RSS_t / n_t) / (1 - edf / n_t)². GBLUP:
  δ = r over the ratio grid tr(K)/n · 10^[-3..3] (13 points), chosen by
  the REML profile Σ log(sᵢ + r) + n_t log Σ ỹᵢ² / (sᵢ + r) on the
  eigenpairs of K_tt.
- lasso: per fold, Z centered over the training rows, the λ grid from
  λ_max = max_j |Σ_i (y_i - ȳ) x_ij| / n over every entry, 16 points down to
  λ_max / 100; 300 FISTA steps from 0 of (1/2n_t)‖y_t - ȳ_t - Z_t b‖² +
  λ‖b‖₁ with the step 1/L, L the top eigenvalue of Z_tᵀZ_t / n_t by 30
  power iterations from a ramp, the momentum restarted for the last
  max(20, 300 // 8) steps; λ chosen by training GCV with the number of
  nonzero effects as the degrees of freedom. The configuration states the
  bulk steps' products on bfloat16 operands (effects, design and residuals
  rounded to bfloat16, products summed exactly), the polish steps' in
  float32: the reference rounds those operands to bfloat16 too and sums in
  float64.
- metrics of a fold's predictions: Pearson's r, the mean absolute and mean
  squared deviation, their root, the Euclidean distance and 1 - var(d) /
  var(y) (sample variances).

Plain PyTorch in float64 on the device of the panel; imports nothing of the
program. The control computes the same one precision below the
configuration's: products in TF32 where it states float32 (TF32 off), the
lasso's bulk steps on float8 e4m3 operands (one scale per tensor) where it
states bfloat16, the metrics in float32 where it states float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .precision import fp8_round, tf32 as _tf32

MODELS = ("ridge", "gblup", "lasso")  # the models whose CV records this reference judges
RIDGE_LAMBDAS = np.logspace(-4, 1, 12)
FISTA_STEPS = 300
METRICS = ("cor", "mad", "msd", "rmsd", "euc", "r²")
TIE = 1e-4  # ridge and GBLUP criteria this close (log scale) choose alike
POOLED = ("lasso_choice_regret",)  # numbers a run averages over its calls; the others take the worst


def folds(seed: int, n: int, n_replications: int, n_folds: int) -> list[tuple[str, str, np.ndarray]]:
    """(replication tag, fold tag, training mask) of every fold."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(1, n_replications + 1):
        labels = rng.integers(1, n_folds + 1, size=n)
        for j in range(1, n_folds + 1):
            out.append((f"replication_{i}", f"fold_{j}", labels != j))
    return out


def _momentum(n: int) -> list[float]:
    out, t = [], 1.0
    for _ in range(n):
        t_new = 0.5 * (1.0 + math.sqrt(1.0 + 4.0 * t * t))
        out.append((t - 1.0) / t_new)
        t = t_new
    return out


def _power_lmax(Zw: torch.Tensor) -> torch.Tensor:
    K = Zw @ Zw.T
    v = torch.linspace(1.0, 2.0, K.shape[0], dtype=K.dtype, device=K.device)
    v = v / torch.linalg.norm(v)
    for _ in range(30):
        v = K @ v
        v = v / torch.linalg.norm(v)
    return v @ (K @ v)


def _fista(Zw, ywc, n_t, lambdas, step, low):
    """B (p, L) after FISTA_STEPS steps, the bulk steps' operands rounded
    to bfloat16; `low` rounds them to float8 e4m3 instead and runs the
    polish in TF32 (the control)."""
    p, L = Zw.shape[1], lambdas.shape[0]
    thr = step * lambdas[None, :]
    n_bulk = FISTA_STEPS - max(20, FISTA_STEPS // 8)

    def rnd(t):
        return fp8_round(t) if low else t.to(torch.bfloat16).to(t.dtype)

    def leg(B, steps, bulk):
        Zl = rnd(Zw) if bulk else Zw
        V = B
        for mom in _momentum(steps):
            R = Zl @ (rnd(V) if bulk else V) - ywc
            G = Zl.T @ (rnd(R) if bulk else R) / n_t
            B_new = torch.sign(V - step * G) * torch.clamp((V - step * G).abs() - thr, min=0.0)
            V = B_new + mom * (B_new - B)
            B = B_new
        return B

    B = torch.zeros((p, L), dtype=Zw.dtype, device=Zw.device)
    with _tf32(low):
        B = leg(B, n_bulk, True)
        return leg(B, FISTA_STEPS - n_bulk, False)


def solve(X: torch.Tensor, y: np.ndarray, seed: int, n_replications: int, n_folds: int,
          models, control: bool = False, config: dict | None = None) -> dict:
    """Every fold's solutions: {(replication, fold, model): {"train": mask,
    "grid": (L,), "crit": (L,) on the criterion's log scale, "preds": (L, n)}},
    float64 (the control: the module docstring). `config`, the cell's
    configuration, is what every reference is handed (a chain's length, say);
    these models need nothing of it."""
    dt = torch.float32 if control else torch.float64
    dev = X.device
    n = X.shape[0]
    Xd = X.to(dt)
    yt = torch.as_tensor(np.asarray(y, dtype=np.float64), dtype=dt, device=dev)
    out = {}
    with _tf32(control):
        Z = Xd - Xd.mean(dim=0)
        K = Z @ Z.T
    tr_scale = float(K.diagonal().sum()) / n
    yd = yt - yt.mean()
    lam_max = max(float((yd @ Xd).abs().max()) / n, 1e-12)
    lasso_grid = np.logspace(np.log10(lam_max), np.log10(lam_max * 0.01), 16)
    for rep, fold, tr in folds(seed, n, n_replications, n_folds):
        t = torch.as_tensor(np.flatnonzero(tr), device=dev)
        n_t = float(len(t))
        y_t = yt[t]
        mean_t = y_t.mean()
        if "ridge" in models or "gblup" in models:
            s, U = torch.linalg.eigh(K[t][:, t])
            s = torch.clamp(s, min=0.0)
            yy = U.T @ (y_t - mean_t)
            K_at = K[:, t]
            for model in ("ridge", "gblup"):
                if model not in models:
                    continue
                if model == "ridge":
                    grid = RIDGE_LAMBDAS
                    d = s[None, :] + torch.as_tensor(grid, dtype=dt, device=dev)[:, None] * n_t
                else:
                    grid = tr_scale * np.logspace(-3.0, 3.0, 13)
                    d = s[None, :] + torch.as_tensor(grid, dtype=dt, device=dev)[:, None]
                with _tf32(control):
                    preds = mean_t + (yy[None, :] / d) @ U.T @ K_at.T
                if model == "ridge":
                    edf = (s[None, :] / d).sum(dim=1)
                    rss = ((y_t[None, :] - preds[:, t]) ** 2).sum(dim=1)
                    crit = torch.log((rss / n_t) / torch.clamp((1.0 - edf / n_t) ** 2, min=1e-6))
                else:
                    crit = (torch.log(torch.clamp(d, min=1e-30)).sum(dim=1)
                            + n_t * torch.log(torch.clamp((yy[None, :] ** 2 / d).sum(dim=1), min=1e-30))) / n_t
                out[(rep, fold, model)] = {"train": tr, "grid": np.asarray(grid, dtype=np.float64),
                                           "crit": crit.double().cpu().numpy(),
                                           "preds": preds.double().cpu().numpy()}
        if "lasso" in models:
            w = torch.as_tensor(tr, dtype=dt, device=dev)
            mean_x = (w[:, None] * Xd).sum(dim=0) / n_t
            Zf = Xd - mean_x
            Zw = w[:, None] * Zf
            with _tf32(control):
                step = 1.0 / max(float(_power_lmax(Zw)) / n_t, 1e-12)
            lams = torch.as_tensor(lasso_grid, dtype=dt, device=dev)
            B = _fista(Zw, (w * (yt - mean_t))[:, None], n_t, lams, step, control)
            with _tf32(control):
                preds = (mean_t + Zf @ B).T
            mse = (((yt[None, :] - preds) * w[None, :]) ** 2).sum(dim=1) / n_t
            df = (B.abs() > 1e-8).sum(dim=0).to(dt)
            crit = torch.log(mse / torch.clamp((1.0 - torch.clamp(df, max=n_t - 1.0) / n_t) ** 2, min=1e-6))
            out[(rep, fold, "lasso")] = {"train": tr, "grid": lasso_grid, "crit": crit.double().cpu().numpy(),
                                         "preds": preds.double().cpu().numpy()}
    return out


def metrics(y_true: np.ndarray, y_pred: np.ndarray, dtype=np.float64) -> dict:
    """METRICS of predictions against observations (sample variances)."""
    yt, yp = np.asarray(y_true, dtype=dtype), np.asarray(y_pred, dtype=dtype)
    d = yt - yp
    vt, vp, vd = np.var(yt, ddof=1), np.var(yp, ddof=1), np.var(d, ddof=1)
    low = vt < 1e-10 or vp < 1e-10
    ct, cp = yt - yt.mean(), yp - yp.mean()
    den = np.sqrt((ct ** 2).sum() * (cp ** 2).sum())
    msd = (d ** 2).mean()
    return {"cor": 0.0 if low or den == 0 else float((ct * cp).sum() / den),
            "mad": float(np.abs(d).mean()), "msd": float(msd), "rmsd": float(np.sqrt(msd)),
            "euc": float(np.sqrt((d ** 2).sum())), "r²": 0.0 if low else float(1.0 - vd / vt)}


def records_of_control(sol: dict, y: np.ndarray) -> list[dict]:
    """The control's own choice and predictions as CV records, its metrics
    in float32, for `compare`."""
    recs = []
    for (rep, fold, model), s in sol.items():
        k = int(np.argmin(s["crit"]))
        tr = s["train"]
        pred = s["preds"][k]
        recs.append({"rep": rep, "fold": fold, "model": model, "train": np.flatnonzero(tr),
                     "val": np.flatnonzero(~tr), "lam": float(s["grid"][k]), "pred_train": pred[tr],
                     "pred_val": pred[~tr], "y_val": y[~tr],
                     "metrics_val": metrics(y[~tr], pred[~tr], np.float32),
                     "metrics_train": metrics(y[tr], pred[tr], np.float32)})
    return recs


def compare(records: list[dict], ref: dict, y: np.ndarray) -> dict:
    """The numbers compared, of one call's CV records against the reference:

    - records_differ: records missing, extra, or whose training or
      validation entries or observed values differ from the reference's fold;
    - pred_gap: ridge and GBLUP, the widest gap of a prediction (training
      and validation entries) from the reference's at the λ its criterion
      chooses, over std(y): this holds the solve and the choice together
      (where the criterion ties within TIE on its log scale, the nearest of
      the tied λ counts);
    - lasso_pred_gap: the same for the lasso at the record's own λ;
    - lasso_choice_regret: the lasso's choice, the reference's GCV (log
      scale) at the record's λ less its least over the grid, mean over the
      lasso records (POOLED: a run averages it over the calls it compares).
      Its GCV counts the nonzero effects of an iterate that is not
      converged, so rounding alone moves a fold's choice between near ties:
      the number is how much worse the chosen λ are, not whether they are
      the same, and one near tie does not set it alone;
    - metric_gap: the widest gap of a reported metric from the metric of the
      record's own predictions, over max(1, |metric|).
    """
    sd = float(np.std(y, ddof=1))
    seen = set()
    differ = pred = lasso = mgap = 0.0
    regrets = []
    for r in records:
        key = (r["rep"], r["fold"], r["model"])
        s = ref.get(key)
        if s is None or key in seen:
            differ += 1
            continue
        seen.add(key)
        tr = s["train"]
        if (not np.array_equal(r["train"], np.flatnonzero(tr)) or not np.array_equal(r["val"], np.flatnonzero(~tr))
                or not np.array_equal(np.asarray(r["y_val"], dtype=np.float64), y[~tr])):
            differ += 1
            continue
        def gap(k):
            return max(float(np.abs(r["pred_train"] - s["preds"][k][tr]).max()),
                       float(np.abs(r["pred_val"] - s["preds"][k][~tr]).max())) / sd

        if r["model"] == "lasso":
            k = int(np.argmin(np.abs(np.log(s["grid"]) - math.log(r["lam"]))))
            lasso = max(lasso, gap(k))
            regrets.append(float(s["crit"][k] - s["crit"].min()))
        else:
            pred = max(pred, min(gap(k) for k in np.flatnonzero(s["crit"] <= s["crit"].min() + TIE)))
        for part, yy, pp in (("metrics_val", y[~tr], r["pred_val"]), ("metrics_train", y[tr], r["pred_train"])):
            want = metrics(yy, pp)
            for m in METRICS:
                mgap = max(mgap, abs(r[part][m] - want[m]) / max(1.0, abs(want[m])))
    differ += len(set(ref) - seen)
    return {"records_differ": differ, "pred_gap": pred, "lasso_pred_gap": lasso, "lasso_choice_regret": float(np.mean(regrets)) if regrets else 0.0,
            "metric_gap": mgap}
