"""The port's out-of-core path held against the JAX package's on the same
.bed trios (written by the JAX package): `BedShardStreamer` shard for shard,
`grm_from_bed`, `gblup_from_bed`, `gblup_from_bed_pieces`, the pieces ops
(`make_bounds`, `unpack_bed_payload`, the piece products, `center_scale_pieces`,
`cg_solve_pieces`, `gblup_from_pieces`), `gram_dosage_snp_major` and the
host→device stage `_iter_device_ahead`, all on the CPU.

Tolerances (over the max of the reference): the streamed GRM 1e-6 (both
packages sum exact integer Grams; the rest is the f32 centering, and K2
against the JAX f32 product for imputed shards); GEBVs 1e-4; the centered
pieces 1e-5; the CG solution 1e-4."""

import numpy as np
import pytest
import torch

import genomicbreedingmodels_tpu as gj
import genomicbreedingmodels_tpu.ops.pieces as pieces_jax
import genomicbreedingmodels_tpu.streaming as stream_jax
from genomicbreedingmodels_tpu.ops.grm import gram_dosage_snp_major as gram_snp_jax
from genomicbreedingmodels_tpu_torch import streaming
from genomicbreedingmodels_tpu_torch.native import lib as native_port
from genomicbreedingmodels_tpu_torch.ops import pieces
from genomicbreedingmodels_tpu_torch.ops.grm import gram_dosage_snp_major

torch.set_num_threads(2)
CPU = "cpu"
GRM_TOL, GEBV_TOL, PIECES_TOL, CG_TOL = 1e-6, 1e-4, 1e-5, 1e-4


def _write(prefix, n, p, seed, missing=0.0):
    rng = np.random.default_rng(seed)
    F = rng.choice([0.0, 0.5, 1.0], size=(n, p), p=[0.4, 0.3, 0.3])
    F[rng.random((n, p)) < missing] = np.nan
    gj.write_bed(gj.Genomes(
        entries=np.array([f"e{i}" for i in range(n)], dtype=object),
        populations=np.array(["pop1"] * n, dtype=object),
        loci_alleles=np.array([f"chr1\t{j + 1}\tA|T\tA" for j in range(p)], dtype=object),
        allele_frequencies=F), prefix)
    return F


@pytest.fixture(scope="module")
def bed_files(tmp_path_factory):
    """tests/test_streaming.py's `bed_trio` (60 x 500, complete) and a copy of
    the same shape with 1 % missing calls."""
    d = tmp_path_factory.mktemp("bed")
    return {"complete": (d / "panel", _write(d / "panel", 60, 500, seed=0)),
            "missing": (d / "miss", _write(d / "miss", 60, 500, seed=0, missing=0.01))}


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _shards(st, mode):
    return {"iter": lambda: iter(st), "dosage": st.iter_dosage,
            "dosage_snp": lambda: st.iter_dosage(snp_major=True), "payload": st.iter_payload}[mode]()


@pytest.mark.parametrize("mode", ["iter", "dosage", "dosage_snp", "payload"])
@pytest.mark.parametrize("which", ["complete", "missing"])
def test_streamer_matches_jax(bed_files, mode, which):
    prefix, _ = bed_files[which]
    a = list(_shards(stream_jax.BedShardStreamer(prefix, block_cols=128, prefetch=2), mode))
    st = streaming.BedShardStreamer(prefix, block_cols=128, prefetch=2)
    b = list(_shards(st, mode))
    assert (st.n, st.p, len(st)) == (60, 500, 4)
    assert [(x[0], x[1]) for x in b] == [(x[0], x[1]) for x in a] == \
        [(0, 128), (128, 256), (256, 384), (384, 500)]
    for (_, _, x), (_, _, y) in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("mode", ["iter", "dosage", "dosage_snp"])
def test_streamer_native_and_numpy_decoders_agree(bed_files, monkeypatch, mode):
    prefix, _ = bed_files["missing"]
    native = list(_shards(streaming.BedShardStreamer(prefix, block_cols=100), mode))
    monkeypatch.setattr(native_port, "load_native", lambda: None)
    plain = list(_shards(streaming.BedShardStreamer(prefix, block_cols=100), mode))
    for (_, _, x), (_, _, y) in zip(native, plain):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("which,dtype,block_cols", [
    ("complete", None, 96), ("complete", None, 500), ("complete", "float32", 96),
    ("missing", None, 128), ("missing", "float32", 64)])
def test_grm_from_bed_matches_jax(bed_files, which, dtype, block_cols):
    prefix, _ = bed_files[which]
    ref = np.asarray(stream_jax.grm_from_bed(prefix, block_cols=block_cols, dtype=dtype))
    got = streaming.grm_from_bed(prefix, block_cols=block_cols, dtype=dtype, device=CPU)
    assert got.dtype == torch.float32 and got.shape == (60, 60)
    assert _rel(got, ref) <= GRM_TOL
    assert torch.equal(got, got.T)


def test_grm_from_bed_uncentered_matches_jax(bed_files):
    prefix, _ = bed_files["complete"]
    ref = np.asarray(stream_jax.grm_from_bed(prefix, block_cols=128, center=False))
    assert _rel(streaming.grm_from_bed(prefix, block_cols=128, center=False, device=CPU), ref) <= GRM_TOL


@pytest.mark.parametrize("which", ["complete", "missing"])
def test_gblup_from_bed_matches_jax(bed_files, which):
    prefix, F = bed_files[which]
    rng = np.random.default_rng(1)
    y = np.nan_to_num(F) @ (rng.normal(size=F.shape[1]) * (rng.random(F.shape[1]) < 0.05)) \
        + 0.5 * rng.normal(size=F.shape[0])
    g_ref, K_ref = stream_jax.gblup_from_bed(prefix, y, lam=0.2, block_cols=128)
    g, K = streaming.gblup_from_bed(prefix, y, lam=0.2, block_cols=128, device=CPU)
    assert _rel(g, g_ref) <= GEBV_TOL
    assert _rel(K, K_ref) <= GRM_TOL
    assert abs(float(K.diagonal().mean()) - 1.0) < 1e-5


@pytest.mark.parametrize("cols", [1, 31, 128])
def test_gram_dosage_snp_major_matches_jax(cols):
    F = np.random.default_rng(cols).integers(0, 3, size=(cols, 45)).astype(np.int8)
    for center in (True, False):
        ref = np.asarray(gram_snp_jax(F, ploidy=2, center=center))
        got = gram_dosage_snp_major(F, ploidy=2, center=center, device=CPU)
        if center:
            assert _rel(got, ref) <= GRM_TOL
        else:  # exact integers over 4
            np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("n,b", [(1, 4096), (60, 16), (61, 16), (4096, 4096), (9000, 4096)])
def test_make_bounds_equal(n, b):
    assert pieces.make_bounds(n, b) == pieces_jax.make_bounds(n, b)


@pytest.mark.parametrize("n,p,missing", [(13, 9, 2), (60, 128, 0), (61, 77, 5)])
def test_unpack_bed_payload_exact(tmp_path, n, p, missing):
    """The port's unpack equals the JAX package's and the decoded panel
    (missing as 0), the count included; n % 4 != 0 checks that the padding
    bit pairs are not counted."""
    rng = np.random.default_rng(5)
    F = rng.choice([0.0, 0.5, 1.0], size=(n, p))
    F.flat[rng.choice(n * p, size=missing, replace=False)] = np.nan
    gj.write_bed(gj.Genomes(entries=np.array([f"e{i}" for i in range(n)], dtype=object),
                            populations=np.array(["p"] * n, dtype=object),
                            loci_alleles=np.array([f"c\t{j}\tA|T\tA" for j in range(p)], dtype=object),
                            allele_frequencies=F), tmp_path / "r")
    _, _, payload = next(iter(streaming.BedShardStreamer(tmp_path / "r", block_cols=p).iter_payload()))
    assert payload.shape == (p, (n + 3) // 4)
    D, miss = pieces.unpack_bed_payload(torch.from_numpy(payload), n)
    D_ref, miss_ref = pieces_jax.unpack_bed_payload(payload, n)
    assert D.dtype == torch.int8 and int(miss) == int(miss_ref) == missing
    np.testing.assert_array_equal(D.numpy(), np.asarray(D_ref))
    np.testing.assert_array_equal(D.numpy(), np.nan_to_num(F.T * 2, nan=0.0).astype(np.int8))


def _raw_pieces(n, p, block_rows, seed, n_shards=3):
    """The same int8 shards accumulated by both packages; returns (port
    pieces, JAX pieces, bounds, shards)."""
    rng = np.random.default_rng(seed)
    shards = [rng.integers(0, 3, size=(p, n)).astype(np.int8) for _ in range(n_shards)]
    bounds = pieces.make_bounds(n, block_rows)
    pt = pieces.zero_pieces(n, bounds, device=CPU)
    pj = pieces_jax.zero_pieces(n, bounds)
    for F in shards:
        pieces.accumulate_dosage_shard(pt, torch.from_numpy(F), bounds=bounds)
        pj = pieces_jax.accumulate_dosage_shard(pj, F, bounds=bounds)
    return pt, pj, bounds, shards


@pytest.mark.parametrize("n,block_rows", [(60, 16), (45, 64), (100, 24)])
def test_pieces_products_exact_and_centered(n, block_rows):
    """Raw int32 pieces equal JAX's bit for bit and the lower trapezoids of
    the raw Gram; centered and scaled within PIECES_TOL of JAX's with the
    strict upper half of every diagonal block exactly 0; sample-major shards
    give the same pieces."""
    pt, pj, bounds, shards = _raw_pieces(n, 37, block_rows, seed=n)
    G = sum(F.T.astype(np.int64) @ F.astype(np.int64) for F in shards)
    alt = pieces.zero_pieces(n, bounds, device=CPU)
    for F in shards:
        pieces.accumulate_dosage_shard(alt, torch.from_numpy(np.ascontiguousarray(F.T)),
                                       bounds=bounds, snp_major=False)
    for (lo, hi), a, b, c in zip(bounds, pt, pj, alt):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(a.numpy(), G[lo:, lo:hi])
        assert torch.equal(a, c)
    ct = pieces.center_scale_pieces(pt, 4.0, bounds=bounds)
    cj = pieces_jax.center_scale_pieces(pj, np.float32(4.0), bounds=bounds)
    scale = max(float(np.abs(np.asarray(c)).max()) for c in cj)
    for (lo, hi), a, b in zip(bounds, ct, cj):
        assert a.dtype == torch.float32
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) <= PIECES_TOL * scale
        assert not torch.triu(a[: hi - lo], 1).any()


@pytest.mark.parametrize("iters", [5, 30, 300])
def test_cg_solve_pieces_matches_jax(iters):
    n = 70
    pt, pj, bounds, _ = _raw_pieces(n, 200, 16, seed=3)
    ct = pieces.center_scale_pieces(pt, 4.0, bounds=bounds)
    cj = pieces_jax.center_scale_pieces(pj, np.float32(4.0), bounds=bounds)
    y = np.random.default_rng(4).normal(size=n).astype(np.float32)
    g, r = pieces.cg_solve_pieces(ct, torch.from_numpy(y), 1e-3, bounds=bounds, iters=iters)
    g_ref, r_ref = pieces_jax.cg_solve_pieces(cj, y, np.float32(1e-3), bounds=bounds, iters=iters)
    assert _rel(g, g_ref) <= CG_TOL
    if iters == 300:  # converged: both residuals at the float32 floor
        assert float(r) < 1e-3 and float(r_ref) < 1e-3


def test_gblup_from_pieces_matches_jax():
    pt, pj, bounds, _ = _raw_pieces(50, 120, 16, seed=6)
    y = np.random.default_rng(7).normal(size=50)
    g, r = pieces.gblup_from_pieces(pt, y, bounds, lam_rel=1e-2, iters=40)
    g_ref, _ = pieces_jax.gblup_from_pieces(pj, y, bounds, lam_rel=1e-2, iters=40)
    assert _rel(g, g_ref) <= CG_TOL and float(r) < 1e-3


def test_accumulate_bed_payload_matches_jax(bed_files):
    prefix, F = bed_files["missing"]
    st = streaming.BedShardStreamer(prefix, block_cols=200)
    bounds = pieces.make_bounds(st.n, 16)
    pt, pj = pieces.zero_pieces(st.n, bounds, device=CPU), pieces_jax.zero_pieces(st.n, bounds)
    miss, miss_j = torch.zeros((), dtype=torch.int64), np.int32(0)
    for _, _, payload in st.iter_payload():
        pt, miss = pieces.accumulate_bed_payload(pt, torch.from_numpy(payload), miss,
                                                 bounds=bounds, n=st.n)
        pj, miss_j = pieces_jax.accumulate_bed_payload(pj, payload, miss_j, bounds=bounds, n=st.n)
    assert int(miss) == int(miss_j) == int(np.isnan(F).sum()) > 0
    for a, b in zip(pt, pj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_gblup_from_bed_pieces_matches_dense_and_jax(bed_files):
    """The pieces CG path against the port's dense Cholesky path (the JAX
    test's 2e-3 and residual bound) and against the JAX pieces path."""
    prefix, _ = bed_files["complete"]
    y = np.random.default_rng(9).normal(size=60)
    dense, _ = streaming.gblup_from_bed(prefix, y, lam=0.1, block_cols=128, dtype="float32", device=CPU)
    g, resid = streaming.gblup_from_bed_pieces(prefix, y, lam=0.1, block_cols=128, block_rows=16,
                                               cg_iters=300, device=CPU)
    g_ref, _ = stream_jax.gblup_from_bed_pieces(prefix, y, lam=0.1, block_cols=128, block_rows=16,
                                                cg_iters=300)
    assert g.dtype == np.float64 and resid < 1e-3
    np.testing.assert_allclose(g, dense.numpy(), atol=2e-3)
    assert _rel(g, g_ref) <= GEBV_TOL


def test_gblup_from_bed_pieces_rejects_missing(bed_files):
    prefix, _ = bed_files["missing"]
    with pytest.raises(ValueError, match="missing"):
        streaming.gblup_from_bed_pieces(prefix, np.zeros(60), block_cols=64, device=CPU)


def test_iter_device_ahead_order_content_and_inline(monkeypatch):
    """Order and content on the CPU; GBM_STREAM_H2D_AHEAD=0 (inline) yields
    the same stream; an empty stream yields nothing."""
    rng = np.random.default_rng(1)
    shards = [(i * 4, i * 4 + 4, rng.integers(0, 255, size=(4, 7), dtype=np.uint8)) for i in range(5)]
    out = list(streaming._iter_device_ahead(iter(shards), device=CPU))
    assert [(a, b) for a, b, _ in out] == [(a, b) for a, b, _ in shards]
    for (_, _, host), (_, _, t) in zip(shards, out):
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), host)
    monkeypatch.setenv("GBM_STREAM_H2D_AHEAD", "0")
    out2 = list(streaming._iter_device_ahead(iter(shards), device=CPU))
    for (_, _, t1), (_, _, t2) in zip(out, out2):
        assert torch.equal(t1, t2)
    assert list(streaming._iter_device_ahead(iter([]), device=CPU)) == []


def test_streamer_stops_early_without_hanging(bed_files):
    """A consumer that stops after one shard closes the prefetch pool."""
    prefix, _ = bed_files["complete"]
    it = streaming._iter_device_ahead(
        streaming.BedShardStreamer(prefix, block_cols=16, prefetch=3).iter_payload(), device=CPU)
    a, b, t = next(it)
    assert (a, b) == (0, 16) and t.shape == (16, 15)
    it.close()


def test_cuda_device_without_card_raises(bed_files):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    prefix, _ = bed_files["complete"]
    with pytest.raises(RuntimeError, match="CUDA"):
        streaming.grm_from_bed(prefix)


@pytest.mark.parametrize("path", ["center_gram", "center_gram_lower", "center_scale_pieces"])
def test_centering_leaves_no_bias_along_ones(path):
    """Raw Gram entries ~1.25e5 (a large panel's, here 125,000 + X Xᵀ with a
    small X): the centered Gram must send the ones vector to ~0. Formed in
    float32, rm_i + rm_j - gm left 1ᵀK1/n = 11.1 here (-192 at n = 50,000 on
    the card, below λ = 1e-3·mean(diag K), so CG and Cholesky diverged)."""
    from genomicbreedingmodels_tpu_torch.ops import grm as grm_port

    n = 3000
    X = np.random.default_rng(0).integers(0, 3, size=(n, 50)).astype(np.int64)
    G4 = 500_000 + 4 * (X @ X.T)  # raw dosage Gram, 4x the frequency Gram, exact in int32
    if path == "center_scale_pieces":
        bounds = pieces.make_bounds(n, 1024)
        P = pieces.center_scale_pieces([torch.from_numpy(G4[lo:, lo:hi].astype(np.int32))
                                        for lo, hi in bounds], 4.0, bounds=bounds)
        K = np.zeros((n, n))
        for (lo, hi), piece in zip(bounds, P):
            K[lo:, lo:hi] = piece.numpy()
    else:
        G = torch.from_numpy(G4 / 4.0).float()
        K = (grm_port.center_gram(G) if path == "center_gram"
             else grm_port.center_gram_lower(torch.tril(G))).numpy().astype(np.float64)
    K = np.tril(K) + np.tril(K, -1).T
    assert abs(K.sum() / n) < 1e-3
