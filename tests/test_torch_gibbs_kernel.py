"""K3's wrapper and plain version (kernels/gibbs_group.py) held against the
Pallas kernel in interpret mode and a float64 numpy oracle of the same update
law, fed the same Cb, u, effects, noise and scalars; and the chain's grouped
draw held against its one-marker scalar oracle. The CUDA kernel itself runs
only on the card: see tests/test_torch_cuda_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genomicbreedingmodels_tpu.ops.pallas_gibbs import grouped_block_update as gbu_jax
from genomicbreedingmodels_tpu_torch.kernels import gibbs_group
from genomicbreedingmodels_tpu_torch.kernels.gibbs_group import (
    group_scan,
    group_tables,
    grouped_block_update,
    grouped_block_update_plain,
    pattern_bits,
)
from genomicbreedingmodels_tpu_torch.models.bayesian import gibbs_regression

# Bound of the JAX kernel's own test against the f64 oracle
# (tests/test_pallas_kernels.py): f32 rounding of O(1) draws.
ATOL = 5e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(K, bs, n_invalid=3, seed=0, n=40):
    rng = np.random.default_rng(seed)
    G = bs // K
    X = rng.normal(size=(n, bs)).astype(np.float32)
    val = np.ones(bs, np.float32)
    val[bs - n_invalid:] = 0.0
    X[:, val == 0] = 0.0  # padded markers carry zero Gram rows, as in the chain
    return dict(
        Cb=(X.T @ X).astype(np.float32),
        u=(rng.normal(size=bs) * 3).astype(np.float32),
        b=(rng.normal(size=bs) * (rng.random(bs) < 0.3) * val).astype(np.float32),
        s2=np.full(bs, 0.4, np.float32),
        val=val,
        eta=rng.normal(size=bs).astype(np.float32),
        gum=(-np.log(-np.log(rng.random((G, 1 << K)) + 1e-12))).astype(np.float32),
        sig_e2=np.float32(0.8),
        pi=np.float32(0.3),
    )


def _torch_args(a):
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in a.items() if k not in ("sig_e2", "pi")}
    return (t["Cb"], t["u"], t["b"], t["s2"], t["val"], t["eta"], t["gum"],
            torch.tensor(a["sig_e2"]), torch.tensor(a["pi"]))


def _oracle(a, K):
    """From-scratch float64 numpy loop of the update law (one Cholesky per
    pattern), after tests/test_pallas_kernels.py."""
    Cb, u, b, s2, val, eta, gum = (a[k].astype(np.float64) for k in
                                   ("Cb", "u", "b", "s2", "val", "eta", "gum"))
    sig_e2, pi = float(a["sig_e2"]), float(a["pi"])
    bs = len(u)
    pats = ((np.arange(1 << K)[:, None] >> np.arange(K)[None, :]) & 1).astype(np.float64)
    b = b.copy()
    cdelta, d_out, incl = np.zeros(bs), np.zeros(bs), np.zeros(bs)
    for g in range(bs // K):
        r0 = g * K
        C_gg = Cb[r0:r0 + K, r0:r0 + K]
        v = (u[r0:r0 + K] - cdelta[r0:r0 + K] + C_gg @ b[r0:r0 + K]) / sig_e2
        val_g, s2_g = val[r0:r0 + K], s2[r0:r0 + K]
        logws, cand = np.zeros(1 << K), []
        for m in range(1 << K):
            Mg = pats[m] * val_g
            P = (C_gg / sig_e2) * np.outer(Mg, Mg) + np.diag(np.where(Mg > 0, 1 / s2_g, 1.0))
            L = np.linalg.cholesky(P)
            w = np.linalg.solve(L, np.where(Mg > 0, v, 0.0))
            logws[m] = (
                Mg.sum() * np.log(pi) + (val_g * (1 - pats[m])).sum() * np.log1p(-pi)
                - 0.5 * np.sum(np.where(Mg > 0, np.log(s2_g), 0.0))
                - np.sum(np.log(np.diag(L))) + 0.5 * w @ w
                - 1e30 * np.sum(pats[m] * (1 - val_g))
            )
            cand.append((L, w, Mg))
        L, w, Mg = cand[int(np.argmax(logws + gum[g]))]
        b_new = np.where(Mg > 0, np.linalg.solve(L.T, w + eta[r0:r0 + K]), 0.0)
        dd = b_new - b[r0:r0 + K]
        cdelta += dd @ Cb[r0:r0 + K, :]
        d_out[r0:r0 + K], b[r0:r0 + K], incl[r0:r0 + K] = dd, b_new, Mg > 0
    return d_out, b, incl


@pytest.mark.parametrize("K,bs", [(8, 64), (6, 60)])
def test_plain_matches_pallas_interpret(K, bs):
    a = _inputs(K, bs)
    d, bn, incl = (t.numpy() for t in grouped_block_update(*_torch_args(a), K=K))
    dj, bj, ij = (np.asarray(x) for x in gbu_jax(
        *(jnp.asarray(a[k]) for k in ("Cb", "u", "b", "s2", "val", "eta", "gum", "sig_e2", "pi")),
        K=K, interpret=True,
    ))
    assert np.array_equal(incl, ij)
    np.testing.assert_allclose(d, dj, atol=ATOL)
    np.testing.assert_allclose(bn, bj, atol=ATOL)
    assert np.all(bn[-3:] == 0) and np.all(incl[-3:] == 0)


@pytest.mark.parametrize("K,bs,n_invalid", [(8, 64, 3), (6, 60, 3), (4, 24, 5), (1, 10, 2)])
def test_plain_matches_f64_oracle(K, bs, n_invalid):
    a = _inputs(K, bs, n_invalid=n_invalid, seed=K)
    d, bn, incl = (t.numpy() for t in grouped_block_update(*_torch_args(a), K=K))
    d_o, b_o, i_o = _oracle(a, K)
    assert np.array_equal(incl, i_o)
    np.testing.assert_allclose(d, d_o, atol=ATOL)
    np.testing.assert_allclose(bn, b_o, atol=ATOL)
    assert np.all(bn[bs - n_invalid:] == 0)


def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    a = _inputs(6, 60)
    gibbs_group.LAUNCHES["gibbs_group"] = 0
    out = grouped_block_update(*_torch_args(a), K=6)
    ref = grouped_block_update_plain(*_torch_args(a), K=6)
    for x, r in zip(out, ref):
        assert torch.equal(x, r)
    assert gibbs_group.LAUNCHES["gibbs_group"] == 0


def test_sweep_tables_slice_equals_block_tables():
    """The chain's hoisted path (tables for two blocks at once, then one
    block's slice) gives the in-step path's draw."""
    K, bs = 6, 60
    a0, a1 = _inputs(K, bs, seed=1), _inputs(K, bs, seed=2)
    G = bs // K
    Cb = torch.stack([torch.from_numpy(a0["Cb"]), torch.from_numpy(a1["Cb"])])
    s2 = torch.from_numpy(np.stack([a0["s2"], a1["s2"]]))
    val = torch.from_numpy(np.stack([a0["val"], a1["val"]]))
    sig, pi = torch.tensor(a1["sig_e2"]), torch.tensor(a1["pi"])
    pats = pattern_bits(K)
    Cgg = Cb.view(2, G, K, G, K).diagonal(dim1=1, dim2=3).permute(0, 3, 1, 2)
    W, const = group_tables(Cgg, s2.view(2, G, K), val.view(2, G, K), pats, sig, pi)
    args = _torch_args(a1)
    out = group_scan(W[1], const[1], args[6], args[0], args[1], args[2], args[5], sig, pats, args[4])
    ref = grouped_block_update_plain(*args, K=K)
    assert torch.equal(out[2], ref[2])
    for x, r in zip(out[:2], ref[:2]):
        torch.testing.assert_close(x, r, rtol=0, atol=1e-6)


def test_single_pattern_is_the_joint_group_draw():
    """BL's degenerate case (one all-ones pattern, no Gumbel noise): each
    group's draw is the K-dim Gaussian conditional mean + L⁻ᵀη."""
    K, bs = 4, 16
    a = _inputs(K, bs, n_invalid=0, seed=5)
    args = list(_torch_args(a))
    args[6] = None
    d, bn, incl = grouped_block_update_plain(*args, K=K, patterns=pattern_bits(K, indicator=False))
    Cb, u, b, s2, eta = (a[k].astype(np.float64) for k in ("Cb", "u", "b", "s2", "eta"))
    sig = float(a["sig_e2"])
    b_ref, cdelta = b.copy(), np.zeros(bs)
    for g in range(bs // K):
        s = slice(g * K, (g + 1) * K)
        v = (u[s] - cdelta[s] + Cb[s, s] @ b[s]) / sig
        L = np.linalg.cholesky(Cb[s, s] / sig + np.diag(1 / s2[s]))
        b_ref[s] = np.linalg.solve(L.T, np.linalg.solve(L, v) + eta[s])
        cdelta += (b_ref[s] - b[s]) @ Cb[s, :]
    np.testing.assert_allclose(bn.numpy(), b_ref, atol=ATOL)
    np.testing.assert_allclose(d.numpy(), b_ref - b, atol=ATOL)
    assert torch.all(incl == 1)


def test_wrapper_rejects_bad_inputs():
    args = _torch_args(_inputs(6, 60))
    with pytest.raises(ValueError, match="K <= 8"):
        grouped_block_update(*args[:6], torch.zeros(6, 1 << 10), *args[7:], K=10)
    with pytest.raises(ValueError, match="multiple of K"):
        grouped_block_update(*args, K=7)
    with pytest.raises(ValueError, match="gum"):
        grouped_block_update(*args[:6], torch.zeros(10, 32), *args[7:], K=6)
    with pytest.raises(TypeError, match="float32"):
        grouped_block_update(args[0].double(), *args[1:], K=6)
    with pytest.raises(ValueError, match="contiguous"):
        grouped_block_update(args[0].T, *args[1:], K=6)
    with pytest.raises(TypeError, match="torch.Tensor"):
        grouped_block_update(*args[:7], 0.8, args[8], K=6)
    big = (gibbs_group.MAX_BS // 6 + 1) * 6
    with pytest.raises(ValueError, match="shared memory"):
        grouped_block_update(torch.zeros(big, 1), *args[1:], K=6)


@pytest.fixture(scope="module")
def ld_panel():
    """tests/test_bayesian.py's strong-LD panel (8-marker LD blocks, p > n),
    at half the markers (192 for 384; 8 causal for 16) to keep the file's
    time: the scalar scan is one Python step per marker."""
    rng = np.random.default_rng(0)
    n, p = 160, 192
    base = rng.normal(size=(n, p // 8))
    X = np.repeat(base, 8, axis=1) * 0.8 + 0.2 * rng.normal(size=(n, p))
    X = ((X - X.mean(0)) / (X.std(0) + 1e-8)).astype(np.float32)
    b_true = np.zeros(p)
    idx = rng.choice(p, 8, replace=False)
    b_true[idx] = rng.normal(size=8)
    return X, (X @ b_true + 0.5 * rng.normal(size=n)).astype(np.float32)


@pytest.mark.parametrize("model", ["BayesC", "BayesB", "BL"])
def test_grouped_matches_scalar_oracle(ld_panel, model):
    """After tests/test_bayesian.py::test_grouped_indicator_matches_scalar_oracle:
    the grouped 2^K-pattern draw (BL: the single all-ones pattern) and the
    one-marker scan target the same posterior. 450 sweeps, 150 burn-in.
    Bounds: GEBV correlation > 0.99 and σ²ₑ within 25 % (measured ≥ 0.9997
    and ≤ 2.4 % for BayesB/C). BL's σ²ₑ mixes at an ESS of a few per chain,
    and two of the port's scalar BL chains with seeds 1 and 2 agree only to
    0.984 on the reference's panel, so its GEBV bound is 0.98 (measured
    0.988 here), with the reference's stability bounds."""
    X, y = ld_panel
    out = {}
    for upd in ("scalar", "grouped"):
        out[upd] = gibbs_regression(X, y, model=model, n_iter=450, n_burnin=150, seed=1,
                                    indicator_update=upd, device="cpu")
    assert out["scalar"][2]["update"] == "scalar"
    assert out["grouped"][2]["update"] == "grouped-hoisted"
    b_s, b_g = out["scalar"][1], out["grouped"][1]
    assert np.corrcoef(X @ b_s, X @ b_g)[0, 1] > (0.98 if model == "BL" else 0.99)
    s2_s = float(np.mean(out["scalar"][2]["sigma_e2_trace"][150:]))
    s2_g = float(np.mean(out["grouped"][2]["sigma_e2_trace"][150:]))
    if model == "BL":
        assert 0.25 < s2_g / s2_s < 4.0
        assert np.all(np.isfinite(b_g)) and np.all(np.isfinite(b_s))
        assert np.all(out["grouped"][2]["sigma_e2_trace"] < 1e3)
    else:
        assert np.corrcoef(b_s, b_g)[0, 1] > 0.95
        assert abs(s2_s - s2_g) / s2_s < 0.25


# -- the CUDA kernel's geometry, computed in Python (the kernel itself runs
# only on the card) ---------------------------------------------------------

SMEM_MAX = 232_448  # bytes of shared memory one CTA may use on Hopper


@pytest.mark.parametrize("bs,K", [(600, 6), (600, 8), (1024, 8), (gibbs_group.MAX_BS, 8), (258, 6),
                                  (10, 1), (66, 6), (gibbs_group.MAX_BS, 1)])
def test_k3_layout(bs, K):
    """A group's slice is 16-byte aligned and holds W̃'s lower entries and the
    constant of every pattern plus K² + 4K floats of scan inputs; shared
    memory (3 slices, 3 stages of staged Cb quads, w, two output records and
    the mbarriers) fits one CTA; every quad is staged up to bs=1024 at K=8."""
    lay = gibbs_group.k3_layout(bs, K)
    npat, G = 1 << K, bs // K
    used = npat * (K * (K + 1) // 2 + 1) + K * K + 4 * K
    assert lay.slice_floats % 4 == 0 and used <= lay.slice_floats < used + 4
    assert lay.groups == G and lay.table_floats == G * lay.slice_floats
    assert lay.quads == -(-bs // 4)
    assert lay.builders == -(-G // max(1, 256 // npat))
    assert lay.smem_bytes == 4 * (8 + 3 * lay.slice_floats + 4 * lay.quads + 6 * K) + 16 * 3 * K * lay.staged_quads
    assert lay.smem_bytes <= SMEM_MAX
    assert 0 <= lay.staged_quads <= lay.quads
    # Staging stops only where one more quad would overflow shared memory.
    assert lay.staged_quads == lay.quads or lay.smem_bytes + 16 * 3 * K > SMEM_MAX
    assert (lay.staged_quads < lay.quads) == (bs == gibbs_group.MAX_BS and K == 8)


def test_k3_layout_fits_every_block():
    """Every block the wrapper takes (1 ≤ K ≤ 8, bs ≤ MAX_BS) fits shared memory."""
    for K in range(1, gibbs_group.MAX_K + 1):
        for bs in range(K, gibbs_group.MAX_BS + 1, 61 * K):
            lay = gibbs_group.k3_layout(bs, K)
            assert lay.smem_bytes <= SMEM_MAX and lay.staged_quads >= 0, (bs, K)


def test_next_epoch_never_zero():
    """A fresh flag is 0; the epoch runs 1 … 2³¹−1 and wraps to 1, within int32."""
    assert gibbs_group.next_epoch(0) == 1
    assert gibbs_group.next_epoch(41) == 42
    assert gibbs_group.next_epoch(2**31 - 1) == 1
    e = 2**31 - 3
    for _ in range(5):
        e = gibbs_group.next_epoch(e)
        assert 0 < e < 2**31


def test_workspace_per_stream_grows_and_counts_epochs():
    """One workspace per (device, stream), reused from call to call with the
    next epoch; grown, with fresh zero flags, when a layout needs more."""
    dev, spaces = torch.device("cpu"), gibbs_group._WORKSPACES
    small, big = gibbs_group.k3_layout(60, 6), gibbs_group.k3_layout(600, 8)
    try:
        t1, f1, e1 = gibbs_group._workspace(dev, 1, small)
        t2, f2, e2 = gibbs_group._workspace(dev, 1, small)
        assert (e1, e2) == (1, 2) and t2 is t1 and f2 is f1
        assert t1.numel() == small.table_floats and f1.numel() == small.builders
        _, _, e_other = gibbs_group._workspace(dev, 2, small)
        assert e_other == 1
        t3, f3, e3 = gibbs_group._workspace(dev, 1, big)
        assert t3.numel() == big.table_floats and f3.numel() == big.builders
        assert e3 == 1 and not f3.any()
        t4, _, e4 = gibbs_group._workspace(dev, 1, small)  # a smaller block keeps the larger one
        assert t4 is t3 and e4 == 2
    finally:
        spaces.pop((dev, 1), None)
        spaces.pop((dev, 2), None)


def test_workspace_epochs_distinct_under_threads():
    """8 threads × 500 workspace requests on one (device, stream) key, with a
    tiny switch interval: every request gets its own epoch and together they
    are 1 … 4000 (a lost update would repeat an epoch, and two launches with
    one epoch let the second one's scan read the first one's tables)."""
    import sys
    import threading

    dev, key = torch.device("cpu"), 7
    lay = gibbs_group.k3_layout(60, 6)
    got = [[] for _ in range(8)]

    def worker(out):
        for _ in range(500):
            out.append(gibbs_group._workspace(dev, key, lay)[2])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(g,)) for g in got]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        gibbs_group._WORKSPACES.pop((dev, key), None)
    epochs = sorted(e for g in got for e in g)
    assert epochs == list(range(1, 4001))
    assert all(g == sorted(g) for g in got)  # each thread's epochs increase
