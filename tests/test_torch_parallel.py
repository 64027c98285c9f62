"""The port's mesh paths (genomicbreedingmodels_tpu_torch/parallel/) on thread
ranks over gloo on the CPU, held against the JAX package's sharded functions
on its 8-device virtual CPU mesh (tests/conftest.py) and against the port's
single-device functions. Every result is also checked to be the same bits on
every rank."""

import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import genomicbreedingmodels_tpu_torch as gt
from genomicbreedingmodels_tpu.parallel import sharded as sj
from genomicbreedingmodels_tpu.parallel.mesh import make_mesh as make_mesh_j
from genomicbreedingmodels_tpu_torch.ops.grm import gram_dosage, gram_panel
from genomicbreedingmodels_tpu_torch.parallel import sharded as st
from genomicbreedingmodels_tpu_torch.parallel.distributed import (
    distributed_init,
    make_multihost_mesh,
    process_local_panel_slice,
)
from genomicbreedingmodels_tpu_torch.parallel.mesh import (
    RankAborted,
    make_mesh,
    marker_sharding,
    replicated,
    run_ranks,
    shard_range,
)

CPU = "cpu"
ROOT = Path(__file__).resolve().parents[1]


def _same_on_all(outs):
    """Every rank's result, bit for bit the first rank's; returns it."""
    def flat(o):
        return list(o) if isinstance(o, (tuple, list)) else [o]

    first = flat(outs[0])
    for o in outs[1:]:
        for a, b in zip(first, flat(o)):
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b)
            else:
                assert np.array_equal(np.asarray(a), np.asarray(b))
    return outs[0]


def _jax_cols(X, mesh):
    return jax.device_put(jnp.asarray(X), NamedSharding(mesh, P(None, "mp")))


@pytest.mark.parametrize("D", [1, 2, 4])
def test_sharded_grm_int8_bit_equal_and_near_jax(D):
    rng = np.random.default_rng(11)
    Xi = rng.integers(0, 3, size=(40, 96)).astype(np.int8)
    K = _same_on_all(run_ranks(lambda m: st.sharded_grm(Xi, m), shape=(1, D), device=CPU))
    assert torch.equal(K, gram_dosage(Xi, device=CPU))  # exact int32 sums at any D
    Kj = np.asarray(sj.sharded_grm(_jax_cols(Xi, make_mesh_j((1, D))), make_mesh_j((1, D))))
    assert np.abs(K.numpy() - Kj).max() <= 1e-5 * np.abs(Kj).max()


@pytest.mark.parametrize("D", [1, 2, 4])
def test_sharded_grm_f32_near_single_device_and_jax(D):
    rng = np.random.default_rng(12)
    X = rng.random((40, 96)).astype(np.float32)
    K = _same_on_all(run_ranks(lambda m: st.sharded_grm(X, m), shape=(1, D), device=CPU))
    ref = gram_panel(X, device=CPU)
    assert (K - ref).abs().max() <= 1e-5 * ref.abs().max()
    Kj = np.asarray(sj.sharded_grm(_jax_cols(X, make_mesh_j((1, D))), make_mesh_j((1, D))))
    assert np.abs(K.numpy() - Kj).max() <= 1e-5 * np.abs(Kj).max()


def test_sharded_steps_on_dp_mp_mesh_match_jax():
    """Ridge, GBLUP and multi-trait GBLUP steps on a (2, 2) mesh: the port's
    against JAX's on a (2, 2) mesh of its virtual devices (f32 solves on both
    sides: 1e-4 of the largest value)."""
    rng = np.random.default_rng(1)
    n, p, t = 32, 66, 3  # p and t not multiples of the axes: the padded paths
    X = rng.random((n, p)).astype(np.float32)
    Y = rng.normal(size=(t, n)).astype(np.float32)
    y = Y[0]

    def rank(m):
        b0, beta = st.sharded_ridge_step(X, y, 0.5, m)
        return b0, beta, st.gblup_train_step(X, y, 0.1, m), st.multitrait_gblup_step(X, Y, 0.1, m)

    b0, beta, gebv, gebv_mt = _same_on_all(run_ranks(rank, shape=(2, 2), device=CPU))
    mj = make_mesh_j((2, 2))
    Xj = _jax_cols(X[:, :64], mj)  # the JAX steps want p and t on the axes' multiples
    b0_j, beta_j = sj.sharded_ridge_step(Xj, y, 0.5, mj)

    def close(a, b):
        b = np.asarray(b, np.float64)
        assert np.abs(np.asarray(a, np.float64) - b).max() <= 1e-4 * max(np.abs(b).max(), 1.0)

    (b0_64, beta_64), gebv_64, mt_64 = run_ranks(
        lambda m: (st.sharded_ridge_step(X[:, :64], y, 0.5, m),
                   st.gblup_train_step(X[:, :64], y, 0.1, m),
                   st.multitrait_gblup_step(X[:, :64], Y[:2], 0.1, m)),
        shape=(2, 2), device=CPU)[0]
    close(b0_64, b0_j)
    close(beta_64, beta_j)
    close(gebv_64, sj.gblup_train_step(Xj, y, 0.1, mj))
    Yj = jax.device_put(jnp.asarray(Y[:2]), NamedSharding(mj, P("dp", None)))
    close(mt_64, sj.multitrait_gblup_step(Xj, Yj, 0.1, mj))
    # The padded (p = 66, t = 3) steps against float64 closed forms.
    Z = X.astype(np.float64) - X.mean(0)
    yc = y - y.mean()
    beta_ref = np.linalg.solve(Z.T @ Z + n * 0.5 * np.eye(p), Z.T @ yc)
    close(beta, beta_ref)
    close(b0, y.mean() - X.mean(0) @ beta_ref)
    Kn = Z @ Z.T / p
    gebv_ref = Kn @ np.linalg.solve(Kn + 0.1 * np.eye(n), yc) + y.mean()
    close(gebv, gebv_ref)
    assert gebv_mt.shape == (t, n)
    close(gebv_mt[0], gebv_ref)


def test_sharded_gblup_cg_matches_jax_and_dense():
    rng = np.random.default_rng(0)
    n, p = 120, 603
    X = rng.random((n, p)).astype(np.float32)
    y = (X[:, :20] @ rng.normal(size=20) + 0.5 * rng.normal(size=n)).astype(np.float32)
    alpha, gebv = _same_on_all(run_ranks(lambda m: st.sharded_gblup_cg(X, y, 0.1, m),
                                         shape=(1, 4), device=CPU))
    Z = X.astype(np.float64) - X.mean(0)
    K = Z @ Z.T / p
    a_ref = np.linalg.solve(K + 0.1 * np.eye(n), y - y.mean())
    assert np.abs(alpha.numpy() - a_ref).max() < 1e-4
    assert np.abs(gebv.numpy() - (K @ a_ref + y.mean())).max() < 1e-4
    a_j, _ = sj.sharded_gblup_cg(X, y, lam=0.1, mesh=make_mesh_j((1, 8)))
    assert np.abs(alpha.numpy() - np.asarray(a_j)).max() < 1e-4


def test_sharded_gwas_scans_match_jax_and_single_device():
    """The three scans at D = 3 (p = 120 pads to 123) against JAX's on its
    8-device mesh and against the port's unsharded scan kernels (columns are
    independent, so the statistics agree to f32 rounding)."""
    from genomicbreedingmodels_tpu_torch.models import gwas as gw

    rng = np.random.default_rng(7)
    n, p = 48, 120
    G = rng.normal(size=(n, p)).astype(np.float32)
    G = (G - G.mean(0)) / G.std(0, ddof=1)
    y = (G[:, :4] @ np.array([1.5, -1.0, 0.8, 0.6]) + rng.normal(size=n)).astype(np.float32)
    y = (y - y.mean()) / y.std(ddof=1)
    K = (G @ G.T / p).astype(np.float32)

    def rank(m):
        return (st.sharded_gwasols(G, y, K, m), st.sharded_gwaslmm(G, y, K, m),
                st.sharded_gwasreml(G, y, K, m, n_grid=8, n_newton=6))

    t_sh, zl_sh, z_sh = _same_on_all(run_ranks(rank, shape=(1, 3), device=CPU))
    # Against JAX by correlation, as tests/test_torch_gwas.py holds the
    # unsharded scans (the port's PC1 power iteration starts elsewhere).
    m8 = make_mesh_j((1, 8))
    for mine, theirs in ((t_sh, sj.sharded_gwasols(G, y, K, m8)),
                         (zl_sh, sj.sharded_gwaslmm(G, y, K, m8)),
                         (z_sh, sj.sharded_gwasreml(G, y, K, m8, n_grid=8, n_newton=6))):
        assert np.corrcoef(mine, theirs)[0, 1] >= 0.9999
    Gt, yt, Kt = (torch.from_numpy(a) for a in (G, y, K))
    t_ref = gw._gwasols_scan(Gt, yt, gw._grm_pc1_device(Kt)).double().numpy()
    np.testing.assert_allclose(t_sh, t_ref, rtol=2e-4, atol=2e-4)
    U, yt_r, Ft, inv_d, _ = gw._lmm_null(yt, Kt)
    zl_ref = gw._gls_scan(U.T @ Gt, Ft, yt_r, inv_d).double().numpy()
    np.testing.assert_allclose(zl_sh, zl_ref, rtol=2e-4, atol=2e-4)
    s, U = gw._eigh_device(Kt)
    z_ref = gw._reml_z(U.T @ Gt, U.T @ yt, U.T @ torch.ones_like(yt), s, 8, 6, 1024)
    np.testing.assert_allclose(z_sh, z_ref, rtol=2e-4, atol=2e-4)


def test_gwas_public_api_mesh_dispatch():
    """gwasols/gwaslmm/gwasreml with a two-rank mesh against mesh=None, at
    the tolerances of tests/test_torch_gwas.py's JAX comparisons and the JAX
    package's own mesh dispatch test."""
    genomes = gt.simulate_genomes(n=64, l=160, seed=5)
    trials, _ = gt.simulate_trials(genomes, f_add_dom_epi=np.array([[0.2, 0.0, 0.0]]), n_qtl=4,
                                   seed=5)
    phenomes = gt.extract_phenomes(trials)
    for name in ("gwasols", "gwaslmm", "gwasreml"):
        fn = getattr(gt, name)
        f0 = fn(genomes, phenomes, device=CPU)
        f1 = _same_on_all(run_ranks(lambda m: fn(genomes, phenomes, mesh=m).b_hat, shape=(1, 2),
                                    device=CPU))
        assert np.corrcoef(f1, f0.b_hat)[0, 1] >= 0.9999
        assert np.argmax(np.abs(f1)) == np.argmax(np.abs(f0.b_hat))
        np.testing.assert_allclose(f1, f0.b_hat, rtol=2e-2, atol=2e-2)


def test_two_ranks_on_different_panels_keep_their_own_caches():
    """Two ranks run the single-device Gibbs chain and GWAS prep at the same
    time on different panels: each gets the result it gets alone (the
    single-slot device caches never hand one rank the other's upload)."""
    rng = np.random.default_rng(3)
    Xs = [rng.random((50, 90)).astype(np.float32) for _ in range(2)]
    ys = [rng.normal(size=50).astype(np.float32) for _ in range(2)]
    kw = dict(model="BayesC", n_iter=30, n_burnin=5, seed=2, device=CPU)
    outs = run_ranks(lambda m: gt.gibbs_regression(Xs[m.rank], ys[m.rank], **kw)[:2],
                     shape=(1, 2), device=CPU)
    for r in range(2):
        mu, b, _ = gt.gibbs_regression(Xs[r], ys[r], **kw)
        assert outs[r][0] == mu and np.array_equal(outs[r][1], b)


def test_rank_failure_fails_every_rank_promptly():
    def rank(m):
        if m.rank == 1:
            raise ValueError("rank 1 fails before its collective")
        return m.allreduce(torch.ones(3))  # would wait for rank 1 forever

    t0 = time.perf_counter()
    with pytest.raises(ValueError, match="rank 1 fails"):
        run_ranks(rank, shape=(1, 2), device=CPU, timeout=120.0)
    assert time.perf_counter() - t0 < 30.0
    assert issubclass(RankAborted, RuntimeError)


def test_mesh_collectives_and_helpers():
    def rank(m):
        t = torch.full((2,), float(m.rank))
        sl = marker_sharding(m, 8, "mp")
        return (m.allreduce(t, "mp"), m.allreduce(t, "dp"), m.allreduce(t), m.allgather(t, "mp"),
                m.broadcast(t, "dp", 1), replicated(m, t), (sl.start, sl.stop), dict(m.coords))

    outs = run_ranks(rank, shape=(2, 2), device=CPU)
    for r, (s_mp, s_dp, s_all, g_mp, b_dp, rep, sl, coords) in enumerate(outs):
        row, col = divmod(r, 2)
        assert coords == {"dp": row, "mp": col}
        assert s_mp.tolist() == [4 * row + 1.0] * 2  # ranks 2·row and 2·row + 1
        assert s_dp.tolist() == [2.0 * col + 2] * 2  # ranks col and col + 2
        assert s_all.tolist() == [6.0] * 2
        assert g_mp.tolist() == [2.0 * row] * 2 + [2.0 * row + 1] * 2
        assert b_dp.tolist() == [2.0 + col] * 2 and rep.tolist() == [0.0] * 2
        assert sl == (4 * col, 4 * col + 4)
    assert [shard_range(10, 3, i) for i in range(3)] == [(0, 4), (4, 7), (7, 10)]
    with pytest.raises(ValueError, match="positive"):
        run_ranks(lambda m: None, shape=(2, 0), device=CPU)


def test_distributed_helpers_single_process(monkeypatch):
    for var in ("GBM_COORDINATOR", "MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert distributed_init() is False
    mesh = make_multihost_mesh(devices=[CPU])
    assert mesh.shape == {"dp": 1, "mp": 1} and mesh.device.type == "cpu"
    assert make_mesh(devices=[CPU]).allreduce(torch.ones(2)).tolist() == [1.0, 1.0]
    assert process_local_panel_slice(1000) == (0, 1000)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh((1, 2), devices=[CPU])


@pytest.mark.parametrize("n_devices", [2, 4])
def test_dryrun_multichip_twin(n_devices):
    from genomicbreedingmodels_tpu_torch.entry import _factor_ranks, dryrun_multichip

    assert _factor_ranks(n_devices) == ((2, n_devices // 2) if n_devices == 4 else (1, 2))
    dryrun_multichip(n_devices, device=CPU)


def test_two_processes_through_distributed_init(tmp_path):
    """Two spawned CPU processes meet through `distributed_init` over a
    FileStore, build the mesh from the default group and compute the int8
    sharded GRM: both equal the single-device GRM bit for bit. The children
    import the port only."""
    rng = np.random.default_rng(5)
    Xi = rng.integers(0, 3, size=(30, 70)).astype(np.int8)
    np.save(tmp_path / "X.npy", Xi)
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        import numpy as np, torch
        from genomicbreedingmodels_tpu_torch.parallel.distributed import distributed_init
        from genomicbreedingmodels_tpu_torch.parallel.mesh import make_mesh
        from genomicbreedingmodels_tpu_torch.parallel.sharded import sharded_grm
        rank = int(sys.argv[1])
        assert distributed_init(init_method="file://{tmp_path}/store", num_processes=2,
                                process_id=rank, backend="gloo", timeout=120)
        mesh = make_mesh(devices=["cpu", "cpu"])
        assert mesh.shape == {{"dp": 1, "mp": 2}} and mesh.coords["mp"] == rank
        K = sharded_grm(np.load("{tmp_path}/X.npy"), mesh)
        np.save("{tmp_path}/K%d.npy" % rank, K.numpy())
        torch.distributed.destroy_process_group()
        print("ok", rank)
    """)
    env = {"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env, cwd=str(tmp_path))
             for r in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err[-2000:]
        assert out.strip() == f"ok {r}"
    ref = gram_dosage(Xi, device=CPU).numpy()
    for r in range(2):
        assert np.array_equal(np.load(tmp_path / f"K{r}.npy"), ref)


@pytest.mark.parametrize("D", [1, 2])
def test_weak_scaling_harness_twin(D):
    """scripts/torch_weak_scaling.py, the twin of scripts/weak_scaling.py
    (tests/test_parallel.py's smoke run): every stage runs on thread ranks
    and reports a positive time, one JSON line per (D, stage) and a summary
    with the JAX harness's efficiency keys."""
    import importlib.util
    import json

    spec = importlib.util.spec_from_file_location("torch_weak_scaling",
                                                  ROOT / "scripts" / "torch_weak_scaling.py")
    ws = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ws)
    counts = (1, D) if D > 1 else (1,)
    lines = []
    results = ws.run_weak_scaling(device_counts=counts, n=48, p_per_device=128, gibbs_iters=2,
                                  cg_iters=4, emit=lines.append, device=CPU)
    assert set(results) == set(counts)
    for d in counts:
        assert set(results[d]) == {"grm", "gibbs", "cg"}
        assert all(np.isfinite(v) and v > 0 for v in results[d].values())
    rows = [json.loads(s) for s in lines[:-1]]
    assert [(r["devices"], r["stage"], r["p_total"]) for r in rows] == [
        (d, s, 128 * d) for d in counts for s in ("grm", "gibbs", "cg")]
    summary = json.loads(lines[-1])
    assert summary["summary"] and summary["device"] == "cpu"
    for s in ("grm", "gibbs", "cg"):
        assert summary[f"efficiency_{s}"]["1"] == 1.0
        assert set(summary[f"efficiency_{s}_core_normalized"]) == {str(d) for d in counts}
