"""Marker-sharded compute paths over a mesh of ranks, torch port of
genomicbreedingmodels_tpu/parallel/sharded.py.

Design (BASELINE's north star): the n x p panel is column-sharded (markers)
over the mesh axis 'mp'; each rank forms its shard's Gram partial
G_d = X_d X_dᵀ on its own card (K1 for int8 dosages, K2 for f32/bf16 panels)
and the partials are all-reduced; the n x n mixed-model solve is replicated
(small beside the Gram); marker effects come back per shard from one local
GEMM and are gathered. 'dp' batches independent problems (traits).

The contract of every function here: every rank of the mesh calls it with
the same global arguments the JAX twin takes; each rank uploads only its own
column shard (host arrays) or slices it from a tensor, zero-padded as the
twin pads (to D·bs for the Gibbs chain, to D for CG and the GWAS scans);
every rank returns the same replicated result, bit for bit (all-reduces and
all-gathers hand every rank the same bits, and every replicated step runs
the same operations on them).

Deliberate divergence (ROADMAP C): under `shard_map` the JAX chain runs the
XLA grouped scan on every shard (its per-shard Pallas kernel is "future
work", JAX sharded.py:227-230); here each rank owns its card, so each rank's
indicator-model block update is K3 on its own shard. The law is the same.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..device import as_tensor
from ..kernels.gram_tri import gram_tri_float, gram_tri_int8
from ..ops.grm import _mirror, center_gram
from .mesh import Mesh

__all__ = ["sharded_grm", "sharded_ridge_step", "gblup_train_step", "multitrait_gblup_step",
           "sharded_gibbs_regression", "sharded_gblup_cg", "sharded_gwasreml", "sharded_gwasols",
           "sharded_gwaslmm"]


def _local_columns(X, mesh: Mesh, axis: str, per: int, dtype: torch.dtype,
                   align: int = 1) -> torch.Tensor:
    """This rank's columns [i·per, (i+1)·per) of the global (n, p) panel `X`
    (numpy or tensor) as a new contiguous `dtype` tensor on the rank's
    device, zero past column p, its width rounded up to `align`."""
    n, p = X.shape
    i = mesh.index(axis)
    a, b = min(i * per, p), min((i + 1) * per, p)
    out = torch.zeros((n, -(-per // align) * align), dtype=dtype, device=mesh.device)
    if isinstance(X, torch.Tensor):
        out[:, : b - a] = X[:, a:b]
    else:
        out[:, : b - a] = torch.from_numpy(np.ascontiguousarray(X[:, a:b]))
    return out


def sharded_grm(X, mesh: Mesh, ploidy: int = 2, axis: str = "mp") -> torch.Tensor:
    """GRM numerator (the centered Gram, (n, n) float32) of a panel
    column-sharded over `axis`.

    int8 input is a dosage panel in {0..ploidy}: each rank's shard goes to K1,
    whose int32 triangle is exact, the triangles are all-reduced in int32
    (exact too), then scaled by 1/ploidy² and centred once as the port's
    single-device `ops/grm.py:gram_dosage` does, so the result equals it bit
    for bit at any D. Float panels (f32, or bf16 kept as it is) go to K2 and
    their f32 triangles are summed, as `ops/grm.py:gram_panel`'s Gram."""
    D = mesh.shape[axis]
    if isinstance(X, torch.Tensor):
        dtype = X.dtype if X.dtype in (torch.int8, torch.bfloat16) else torch.float32
    else:
        dtype = torch.int8 if np.asarray(X).dtype == np.int8 else torch.float32
    per = -(-X.shape[1] // D)
    # int8 shards keep a row of whole 16-byte multiples (K1's TMA reads them
    # as they are); the zero columns add nothing.
    Xl = _local_columns(X, mesh, axis, per, dtype, align=16 if dtype == torch.int8 else 1)
    L = gram_tri_int8(Xl, ploidy) if dtype == torch.int8 else gram_tri_float(Xl)
    L = mesh.allreduce(L, axis)
    del Xl
    G = _mirror(L)
    if dtype == torch.int8:
        G = G.to(torch.float32) / float(ploidy * ploidy)
    return center_gram(G)


def _centered_shard(X, mesh: Mesh, axis: str) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """(Z_d, colmeans_d, p_pad): this rank's f32 shard of X, padded to a
    multiple of D, column-centered (its columns live wholly on the rank)."""
    D = mesh.shape[axis]
    per = -(-X.shape[1] // D)
    Xl = _local_columns(X, mesh, axis, per, torch.float32)
    mean = Xl.mean(0)
    return Xl.sub_(mean), mean, per * D  # in place: the shard is this call's own copy


def _sharded_gram(Zl: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Σ_d Z_d Z_dᵀ over `axis`: each shard's K2 triangle, all-reduced, mirrored."""
    return _mirror(mesh.allreduce(gram_tri_float(Zl.contiguous()), axis))


def sharded_ridge_step(X, y, lam: float, mesh: Mesh, axis: str = "mp"):
    """One RR-BLUP training step over the mesh: (b0 (0-d), beta (p,)), both
    replicated tensors on the rank's device. The dual system
    (K + nλI)γ = y_c is solved replicated; each rank recovers its marker
    block β_d = Z_dᵀγ, and the blocks are gathered."""
    p = X.shape[1]
    y = as_tensor(y, mesh.device, torch.float32)
    n = y.shape[0]
    Zl, mean_l, _ = _centered_shard(X, mesh, axis)
    K = _sharded_gram(Zl, mesh, axis)
    gamma = torch.linalg.solve(K + n * lam * torch.eye(n, device=K.device), y - y.mean())
    beta_l = Zl.T @ gamma
    b0 = y.mean() - mesh.allreduce((mean_l @ beta_l).reshape(1), axis)[0]
    return b0, mesh.allgather(beta_l, axis)[:p]


def gblup_train_step(X, y, lam: float, mesh: Mesh, axis: str = "mp") -> torch.Tensor:
    """Full GBLUP step: sharded Gram, replicated solve, GEBV (n,):
    K (K/p + λI)⁻¹ y_c / p + ȳ with K the centered Gram."""
    p = X.shape[1]
    y = as_tensor(y, mesh.device, torch.float32)
    n = y.shape[0]
    Zl, _, _ = _centered_shard(X, mesh, axis)
    Kn = _sharded_gram(Zl, mesh, axis) / float(p)
    alpha = torch.linalg.solve(Kn + lam * torch.eye(n, device=Kn.device), y - y.mean())
    return Kn @ alpha + y.mean()


def multitrait_gblup_step(X, Y, lam: float, mesh: Mesh) -> torch.Tensor:
    """Multi-trait GBLUP over the whole ('dp', 'mp') mesh: X column-sharded
    over 'mp', the traits Y (t, n) split over 'dp' (zero traits pad t to a
    multiple of dp), each rank solving its traits against the shared Gram.
    Returns the (t, n) GEBVs, replicated."""
    dp_axis, mp_axis = mesh.axis_names
    p = X.shape[1]
    Y = as_tensor(Y, mesh.device, torch.float32)
    t, n = Y.shape
    Zl, _, _ = _centered_shard(X, mesh, mp_axis)
    Kn = _sharded_gram(Zl, mesh, mp_axis) / float(p)
    per = -(-t // mesh.shape[dp_axis])
    j = mesh.index(dp_axis)
    Yl = torch.zeros((per, n), device=mesh.device)
    Yl[: max(0, min(t, (j + 1) * per) - j * per)] = Y[j * per : (j + 1) * per]
    mean = Yl.mean(1, keepdim=True)
    A = Kn + lam * torch.eye(n, device=Kn.device)
    alpha = torch.linalg.solve(A, (Yl - mean).T)  # (n, t_local)
    return mesh.allgather((Kn @ alpha).T + mean, dp_axis)[:t]


def sharded_gblup_cg(X, y, lam: float, mesh: Mesh, axis: str = "mp", n_iter: int = 200,
                     tol: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """Matrix-free GBLUP solve at panel scale: (K + λI)α = y_c with K = ZZᵀ/p
    applied as two GEMVs through the marker-sharded panel; the n x n GRM is
    never formed (memory n·p/D per rank). Conjugate gradients with
    replicated scalars: per iteration one local GEMV pair and one all-reduce
    of an n-vector. Stops after `n_iter` iterations or when ‖r‖ <= tol (the
    residual norm is read on the host each iteration; every rank reads the
    same bits, so every rank stops together). Returns (alpha, gebv),
    replicated, on the rank's device."""
    p = X.shape[1]
    y = as_tensor(y, mesh.device, torch.float32)
    Zl, _, _ = _centered_shard(X, mesh, axis)
    yc = y - y.mean()

    def matvec(v):
        return mesh.allreduce(Zl @ (Zl.T @ v), axis) / float(p) + lam * v

    alpha = torch.zeros_like(yc)
    r, pvec = yc.clone(), yc.clone()
    rs = torch.dot(r, r)
    it = 0
    while it < n_iter and float(rs) > tol * tol:
        Ap = matvec(pvec)
        a = rs / torch.clamp(torch.dot(pvec, Ap), min=1e-30)
        alpha = alpha + a * pvec
        r = r - a * Ap
        rs_new = torch.dot(r, r)
        pvec = r + (rs_new / torch.clamp(rs, min=1e-30)) * pvec
        rs = rs_new
        it += 1
    return alpha, matvec(alpha) - lam * alpha + y.mean()


# ---------------------------------------------------------------------------
# Marker-sharded GWAS scans (BASELINE config 4): each rank scans its own
# marker columns after ONE replicated eigh; statistics are gathered.
# ---------------------------------------------------------------------------


def _scan_inputs(G, y, K, mesh: Mesh, axis: str):
    """(G_d, y, K, p): this rank's marker columns of G (padded to a multiple
    of D, the JAX `_pad_markers`), y and K on the rank's device."""
    D = mesh.shape[axis]
    p = G.shape[1]
    Gl = _local_columns(G, mesh, axis, -(-p // D), torch.float32)
    return (Gl, as_tensor(y, mesh.device, torch.float32), as_tensor(K, mesh.device, torch.float32),
            p)


def sharded_gwasols(G, y, K, mesh: Mesh, axis: str = "mp") -> np.ndarray:
    """Marker-sharded GWAS-OLS t-scan (models/gwas.py:_gwasols_scan): the PC1
    covariate is computed replicated, then each rank runs the closed-form
    Schur-complement scan on its shard. Inputs are the standardised prep
    (G, y, K) of `gwasprep` / `_prep_device`; returns t (p,) float64."""
    from ..models.gwas import _grm_pc1_device, _gwasols_scan

    Gl, y, K, p = _scan_inputs(G, y, K, mesh, axis)
    t = _gwasols_scan(Gl, y, _grm_pc1_device(K))
    return mesh.allgather(t, axis)[:p].double().cpu().numpy()


def sharded_gwasreml(G, y, K, mesh: Mesh, axis: str = "mp", n_grid: Optional[int] = None,
                     n_newton: Optional[int] = None, marker_block: int = 1024) -> np.ndarray:
    """Marker-sharded per-marker 2-VC REML scan (models/gwas.py:_reml_scan):
    the GRM's eigendecomposition runs once, replicated; the rotation UᵀG_d is
    a local GEMM per rank and each rank grid+Newton-scans its own markers
    (`marker_block` at a time) with no collective after the eigh. Returns
    z (p,) float64."""
    from ..models.gwas import _eigh_device, _reml_z
    from ..utils.config import get_config

    cfg = get_config()
    Gl, y, K, p = _scan_inputs(G, y, K, mesh, axis)
    s, U = _eigh_device(K)
    z = _reml_z(U.T @ Gl, U.T @ y, U.T @ torch.ones_like(y), s,
                cfg.reml_grid if n_grid is None else n_grid,
                cfg.reml_newton if n_newton is None else n_newton, marker_block)
    return mesh.allgather(torch.from_numpy(z), axis)[:p].numpy()


def sharded_gwaslmm(G, y, K, mesh: Mesh, axis: str = "mp", return_theta: bool = False):
    """Marker-sharded EMMAX scan (models/gwas.py:gwaslmm): the null-model REML
    (one replicated 2-VC solve), then the per-marker GLS z-scan on each
    rank's shard. Returns z (p,) float64, and the null model's (σ²ₑ, σ²ᵤ)
    tensor with `return_theta`."""
    from ..models.gwas import _gls_scan, _lmm_null

    Gl, y, K, p = _scan_inputs(G, y, K, mesh, axis)
    U, yt, Ft, inv_d, theta = _lmm_null(y, K)
    z = mesh.allgather(_gls_scan(U.T @ Gl, Ft, yt, inv_d), axis)[:p].double().cpu().numpy()
    return (z, theta) if return_theta else z


# ---------------------------------------------------------------------------
# Marker-sharded Bayesian-alphabet Gibbs.
# ---------------------------------------------------------------------------


def sharded_gibbs_regression(
    X,
    y,
    mesh: Mesh,
    axis: str = "mp",
    model: str = "BayesC",
    n_iter: int = 1_500,
    n_burnin: int = 500,
    seed: int = 42,
    block_size: int = 64,
    r2: float = 0.5,
    device_schedule: str = "auto",
    chunk_size: Optional[int] = None,
    indicator_update: Optional[str] = None,
    checkpoint_path: Optional[str] = None,
) -> Tuple[float, np.ndarray]:
    """Marker-sharded Bayesian-alphabet Gibbs over the mesh `axis`; returns
    (mu_hat, b_hat (p,) float64), the same on every rank.

    Each rank owns a contiguous marker shard of whole blocks (p padded to
    D·bs, bs = min(block_size, max(8, p // D)) rounded up to whole groups),
    runs the exact sequential conditionals within it, and keeps the
    replicated residual in step with one all-reduce of the length-n
    X_b·δ per block round (models/bayesian.py:_gibbs_chain, `shard`).
    On the card the indicator models' block update is K3 on each rank's
    own shard ("auto" as in `gibbs_regression`).

    `device_schedule`: "sequential" (the default via "auto": exact
    Gauss-Seidel turns across ranks, the single-card chain's law on any
    panel) or "concurrent" (block-Jacobi rounds against the round-start
    residual: an approximation that degrades when markers correlate across
    shards, and diverges for BL). At D = 1 the chain is `gibbs_regression`'s
    bit for bit (same seeding, same generator, same operations).

    `chunk_size` runs the chain in segments (the same chain bit for bit);
    `checkpoint_path` saves after every segment (forcing segments of
    max(25, n_iter // 4) when no chunk size is given) and resumes from the
    file: rank 0 writes the gathered state, every rank reads back its own
    columns and its own generator."""
    from ..models.bayesian import (
        _MODEL_IDS,
        BAYESIAN_MODELS,
        _center_,
        _gibbs_chain,
        _hyper,
        _plan,
        _setup,
        _Shard,
    )
    from ..utils.checkpoint import load_state, save_state
    from ..utils.config import get_config

    if model not in _MODEL_IDS:
        raise ValueError(f"unknown Bayesian model {model!r}; choose from {BAYESIAN_MODELS}")
    if device_schedule == "auto":
        device_schedule = "sequential"
    if device_schedule not in ("concurrent", "sequential"):
        raise ValueError(f"unknown device_schedule {device_schedule!r}")
    cfg = get_config()
    indicator_update = cfg.mcmc_indicator_update if indicator_update is None else indicator_update
    dev = mesh.device
    D, me = mesh.shape[axis], mesh.index(axis)
    n, p = X.shape
    # bs from p // D, as the JAX twin: each rank's shard is whole blocks.
    update, group_size, bs, _, _ = _plan(model, indicator_update, block_size, max(p // D, 1), dev)
    per = -(-p // (D * bs)) * bs
    n_blocks = per // bs
    y = np.asarray(y.cpu() if isinstance(y, torch.Tensor) else y, dtype=np.float32).reshape(-1)

    Xl = _local_columns(X, mesh, axis, per, torch.float32)
    mu_cols = _center_(Xl)
    panel = _setup(Xl[None], mu_cols[None], bs, n_blocks)
    lo = me * per
    n_real = max(0, min(p, lo + per) - lo)  # this rank's real markers
    valid = torch.zeros(per, dtype=torch.float32, device=dev)
    valid[:n_real] = 1.0
    if isinstance(X, torch.Tensor):  # Σ column variances (ddof 0), as gibbs_regression
        ms_x = float(mesh.allreduce(panel.x2[0, :n_real].sum().reshape(1), axis)[0]) / n
    else:
        ms_x = float(np.sum(np.var(np.asarray(X, dtype=np.float32), axis=0)))
    hyper = _hyper(model, float(np.var(y, ddof=1)), max(ms_x, 1e-8), p, r2)
    y_t = torch.from_numpy(y).to(dev)

    # The scalar draws' generator, seeded as gibbs_regression's (the same on
    # every rank); each rank's per-marker generator from (seed, rank), or
    # the same generator at D = 1.
    s0 = np.random.SeedSequence(seed).generate_state(1, dtype=np.uint64)[0]
    gen = torch.Generator(device=dev).manual_seed(int(s0) & (2**63 - 1))
    if D == 1:
        gen_m = gen
    else:
        s_m = np.random.SeedSequence(seed, spawn_key=(me,)).generate_state(1, dtype=np.uint64)[0]
        gen_m = torch.Generator(device=dev).manual_seed(int(s_m) & (2**63 - 1))
    shard = _Shard(mesh=mesh, axis=axis, seq_rounds=D if device_schedule == "sequential" else 1,
                   marker_gens=[gen_m])

    if chunk_size is None and checkpoint_path is not None:
        chunk_size = max(25, n_iter // 4)  # resume needs segment boundaries
    seg_len = int(min(chunk_size or n_iter, n_iter))
    sharded_parts = (0, 2, 8)  # b, s2, acc_b: this rank's columns
    state, done = None, 0
    if checkpoint_path is not None:
        snap = load_state(checkpoint_path)
        if snap is not None:
            done = int(snap.pop("__done__"))
            state = _unpack_state(snap, sharded_parts, lo, per, D, me, dev)
    mu_hat = b_loc = None
    while done < n_iter:
        seg = int(min(seg_len, n_iter - done))
        mu_t, b_t, _, state = _gibbs_chain(
            panel, y_t, valid, [gen], hyper, _MODEL_IDS[model], int(n_iter), int(n_burnin), bs,
            n_blocks, iters=range(done, done + seg), state_in=state, return_state=True,
            group_size=group_size, pallas_groups=update == "pallas", shard=shard,
        )
        done += seg
        mu_hat, b_loc = mu_t[0], b_t[0]
        if checkpoint_path is not None:
            _save_state(state, done, checkpoint_path, sharded_parts, mesh, axis, D, save_state)
    if mu_hat is None:
        # Resumed from a complete checkpoint: the posterior means straight
        # from the carried accumulators (acc_b, acc_mu, acc_n).
        acc_n = torch.clamp(state[10], min=1e-12)
        b_loc = (state[8] / acc_n[:, None])[0]
        mu_hat = (state[9] / acc_n)[0] - mesh.allreduce((mu_cols * b_loc).sum().reshape(1), axis)[0]
    b_hat = mesh.allgather(b_loc, axis)[:p]
    return float(mu_hat), b_hat.double().cpu().numpy()


def _save_state(state, done, path, sharded_parts, mesh: Mesh, axis, D, save_state) -> None:
    """Gather the chain's state into one snapshot, written by rank 0: the
    sharded parts as whole (1, p_pad) rows, the generators as [scalar,
    per-marker of rank 0, ..., of rank D-1] (just [scalar] at D = 1)."""
    snap = {}
    for i, v in enumerate(state):
        if i in sharded_parts:
            v = mesh.allgather(v[0], axis)[None]
        elif i == 7 and D > 1:
            v = torch.cat([v[:1], mesh.allgather(v[1:], axis)])
        snap[f"s{i}"] = v.cpu().numpy()
    snap["__done__"] = np.asarray(done)
    if mesh.rank == 0:
        save_state(path, snap)
    mesh.barrier()  # no rank returns before the snapshot is on disk


def _unpack_state(snap, sharded_parts, lo, per, D, me, dev):
    """This rank's chain state from a `_save_state` snapshot."""
    out = []
    for i in range(len(snap)):
        v = torch.from_numpy(snap[f"s{i}"])
        if i == 7:
            out.append(v if D == 1 else torch.stack([v[0], v[1 + me]]))
            continue
        if i in sharded_parts:
            v = v[:, lo : lo + per].contiguous()
        out.append(v.to(dev))
    return tuple(out)
