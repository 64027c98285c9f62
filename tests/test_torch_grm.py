"""Port GRM ops (ops/grm.py, core/grm.py) held against their JAX twins on
sim_small-sized panels: 1e-5 relative, plus the lower-triangle contract."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genomicbreedingmodels_tpu as gj
import genomicbreedingmodels_tpu_torch as gt
from genomicbreedingmodels_tpu.ops import grm as grm_jax
from genomicbreedingmodels_tpu_torch import convert
from genomicbreedingmodels_tpu_torch.ops import grm as grm_t

torch.set_num_threads(2)
CPU = "cpu"


def _close(a, b, rel=1e-5):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= rel * np.abs(b).max()


def _panel(sim_small, called=False):
    X = sim_small[0].allele_frequencies
    return np.rint(2.0 * X) / 2.0 if called else X


def _called_genomes(genomes):
    return gj.Genomes(
        entries=genomes.entries, populations=genomes.populations,
        loci_alleles=genomes.loci_alleles,
        allele_frequencies=np.rint(2.0 * genomes.allele_frequencies) / 2.0,
    )


def test_center_gram_matches(sim_small):
    X = _panel(sim_small).astype(np.float32)
    G = X @ X.T
    K = grm_t.center_gram(torch.from_numpy(G))
    _close(K, grm_jax.center_gram(G))
    assert torch.equal(K, K.T)


def test_center_gram_lower_matches_and_checks(sim_small):
    X = _panel(sim_small).astype(np.float32)
    L = np.tril(X @ X.T)
    K = grm_t.center_gram_lower(torch.from_numpy(L)).numpy()
    _close(K, grm_jax.center_gram_lower(L))
    # its lower triangle is the centered Gram
    _close(np.tril(K), np.tril(grm_jax.center_gram(X @ X.T)))
    with pytest.raises(ValueError, match="upper"):
        grm_t.center_gram_lower(torch.from_numpy(X @ X.T))


def test_encode_dosage_matches(sim_small):
    X = _panel(sim_small, called=True)
    assert np.array_equal(grm_t.encode_dosage(X), grm_jax.encode_dosage(X))
    assert grm_t.encode_dosage(_panel(sim_small)) is None
    assert grm_t.encode_dosage(X, ploidy=0) is None


@pytest.mark.parametrize("center", [True, False])
def test_gram_dosage_matches(sim_small, center):
    D = grm_jax.encode_dosage(_panel(sim_small, called=True))
    K = grm_t.gram_dosage(D, ploidy=2, center=center, device=CPU)
    assert K.dtype == torch.float32
    _close(K, grm_jax.gram_dosage(D, ploidy=2, center=center))
    if not center:  # the raw dosage Gram is exact
        assert np.array_equal(K.numpy() * 4, D.astype(np.int64) @ D.T.astype(np.int64))


def test_gram_dosage_lower_matches(sim_small):
    D = grm_jax.encode_dosage(_panel(sim_small, called=True))
    K = grm_t.gram_dosage_lower(D, ploidy=2, device=CPU).numpy()
    Kj = np.asarray(grm_jax.gram_dosage_lower(D, ploidy=2))
    _close(np.tril(K), np.tril(Kj))
    _close(K, Kj)  # the upper holds -(rm_i + rm_j - gm) in both
    _close(np.tril(K), np.tril(np.asarray(grm_jax.gram_dosage(D, ploidy=2))))


@pytest.mark.parametrize("center", [True, False])
def test_gram_panel_matches(sim_small, center):
    X = _panel(sim_small)
    K = grm_t.gram_panel(X, center=center, device=CPU)
    assert K.dtype == torch.float32 and torch.equal(K, K.T)
    _close(K, grm_jax.gram_panel(X.astype(np.float32), center=center))


def test_gram_panel_bf16_input(sim_small):
    # Held against the float64 centered Gram of the same bf16 values: JAX's
    # float32 raw Gram of them already differs by ~1e-5 after centering.
    X = torch.from_numpy(_panel(sim_small)).to(torch.bfloat16)
    K = grm_t.gram_panel(X, device=CPU)
    Z = X.double().numpy()
    Z = Z - Z.mean(axis=0)
    _close(K, Z @ Z.T)
    assert torch.equal(K, grm_t.gram_panel(X.float(), device=CPU))


def test_gram_centered_streams_blocks(sim_small):
    X = _panel(sim_small)
    K = grm_t.gram_centered(X, block_cols=256, device=CPU)
    _close(K, grm_jax.gram_centered(X, block_cols=256))
    _close(K, grm_t.gram_centered(X, device=CPU))


@pytest.mark.parametrize("called", [False, True, "int8"])
def test_gram_auto_matches(sim_small, called):
    if called == "int8":
        # An int8 tensor is a dosage panel: K1's route, exactly JAX's gram_auto
        # of the int8 array (its gram_dosage), where K2 gave ploidy² times it.
        D = np.random.default_rng(0).integers(0, 3, size=(64, 256)).astype(np.int8)
        K = grm_t.gram_auto(torch.from_numpy(D), device=CPU)
        assert np.array_equal(K.numpy(), np.asarray(grm_jax.gram_auto(jnp.asarray(D))))
        assert torch.equal(K, grm_t.gram_dosage(D, device=CPU))
        return
    X = _panel(sim_small, called=called)
    _close(grm_t.gram_auto(X, device=CPU), grm_jax.gram_auto(X))


@pytest.mark.parametrize("called", [False, True])
@pytest.mark.parametrize("kind", ["simple", "ploidy-aware"])
def test_core_grm_matches(sim_small, called, kind):
    genomes = _called_genomes(sim_small[0]) if called else sim_small[0]
    g = convert.genomes_from_reference(genomes)
    if kind == "simple":
        rj, rt = gj.grm_simple(genomes), gt.grm_simple(g, device=CPU)
    else:
        k = gj.infer_ploidy(genomes.allele_frequencies)
        assert gt.infer_ploidy(g.allele_frequencies) == k
        rj, rt = gj.grm_ploidy_aware(genomes, ploidy=k), gt.grm_ploidy_aware(g, ploidy=k, device=CPU)
    assert rt.ploidy == rj.ploidy
    assert rt.denominator == pytest.approx(rj.denominator, rel=1e-12)
    K = rt.genomic_relationship_matrix
    assert isinstance(K, torch.Tensor) and K.dtype == torch.float32
    _close(K, rj.genomic_relationship_matrix)


def test_core_grm_rejects_missing():
    g = gt.simulate_genomes(n=10, l=20, seed=1, sparsity=0.2)
    with pytest.raises(ValueError, match="impute"):
        gt.grm_simple(g, device=CPU)


def test_core_grm_cuda_without_cuda_raises(sim_small):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        gt.grm_simple(convert.genomes_from_reference(sim_small[0]))


# The JAX package's other Gram schedules (ops/grm.py:gram_recursive,
# gram_triangular, gram_centered_blocked, gram_centered_device): library
# products in the port, held to the JAX functions at 1e-5·max|K|. On
# sim_small a centered Gram cancels raw entries ~13x its own size, and the
# JAX functions' float32 products and centering leave them up to 1.19e-5·max|K|
# from the float64 centered Gram of the same values (the port: 5.5e-6). So a
# centered Gram is held to that float64 Gram at 1e-5·max|K| and to the JAX
# function at 2e-5·max|K|, the sum of the two sides' own roundings.


def _close_centered(K, ref, X):
    Z = torch.as_tensor(X).double().numpy()
    Z = Z - Z.mean(axis=0)
    _close(K, Z @ Z.T)
    _close(K, ref, rel=2e-5)


@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("depth", [None, 1, 2, 3])
def test_gram_recursive_matches(sim_small, depth, center):
    X = _panel(sim_small)
    K = grm_t.gram_recursive(X, center=center, depth=depth, device=CPU)
    assert K.dtype == torch.float32 and K.shape == (100, 100)
    ref = grm_jax.gram_recursive(X.astype(np.float32), center=center, depth=depth)
    if center:
        assert torch.equal(K, K.T)  # center_gram mirrors its lower triangle
        _close_centered(K, ref, X.astype(np.float32))
    else:
        _close(K, ref)
        if depth:  # the off-diagonal block of the top level is one product, mirrored
            assert torch.equal(K[50:, :50], K[:50, 50:].T)


@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("nb", [None, 2, 3])
def test_gram_triangular_matches(nb, center):
    # n >= 2048 takes the tiled schedule (below it both take one product);
    # 2050 rows pad to 3·684 at nb=3.
    X = np.random.default_rng(1).random((2050, 48)).astype(np.float32)
    K = grm_t.gram_triangular(X, center=center, nb=nb, device=CPU)
    assert K.shape == (2050, 2050) and K.dtype == torch.float32
    _close(K, grm_jax.gram_triangular(X, center=center, nb=nb))
    b = -(-2050 // (nb or 2))
    if not center:  # an upper tile is its lower twin's transpose
        assert torch.equal(K[b : 2 * b, :b], K[:b, b : 2 * b].T)


def test_gram_triangular_small_n_is_one_product(sim_small):
    X = _panel(sim_small)
    K = grm_t.gram_triangular(X, nb=4, device=CPU)
    _close(K, grm_jax.gram_triangular(X, nb=4))
    assert torch.equal(K, grm_t.gram_recursive(X, depth=0, device=CPU))  # one product


def test_gram_recursive_algebraic_centering_beats_bf16_centering():
    """tests/test_grm_ops.py's case on the port: the centering runs on the
    f32 Gram of the bf16 panel, far closer to the float64 centered Gram of
    the same values than a bf16 subtract of the column means."""
    Xb = torch.from_numpy(np.random.default_rng(5).random((128, 2048))).to(torch.bfloat16)
    X64 = Xb.double().numpy()  # what the product sees
    Z = X64 - X64.mean(axis=0, keepdims=True)
    K64 = Z @ Z.T
    K_alg = grm_t.gram_recursive(Xb, depth=2, device=CPU).double().numpy()
    mean_bf = torch.from_numpy(X64.mean(axis=0)).to(torch.bfloat16).double().numpy()
    Zb = torch.from_numpy(X64 - mean_bf).to(torch.bfloat16).double().numpy()
    den = np.abs(K64).max()
    err_alg = np.abs(K_alg - K64).max() / den
    err_bf16 = np.abs(Zb @ Zb.T - K64).max() / den
    assert err_alg < err_bf16 / 5
    assert err_alg < 1e-4


def test_gram_centered_blocked_is_gram_centered(sim_small):
    X = _panel(sim_small)
    K = grm_t.gram_centered_blocked(X, block_cols=256, device=CPU)
    assert torch.equal(K, grm_t.gram_centered(X, block_cols=256, device=CPU))
    _close(K, grm_jax.gram_centered_blocked(X, block_cols=256))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_gram_centered_device_matches(sim_small, use_pallas, bf16):
    from genomicbreedingmodels_tpu.ops.pallas_kernels import grm_pallas

    X = torch.from_numpy(_panel(sim_small).astype(np.float32))
    if bf16:
        X = X.to(torch.bfloat16)
    K = grm_t.gram_centered_device(X, use_pallas=use_pallas, device=CPU)
    assert K.dtype == torch.float32 and K.shape == (100, 100)
    Xj = np.asarray(X.float().numpy())
    Xj = jnp.asarray(Xj, jnp.bfloat16) if bf16 else Xj
    # the JAX option's Pallas kernel runs in interpret mode here, as its own tests run it
    ref = grm_pallas(Xj, interpret=True) if use_pallas else grm_jax.gram_centered_device(Xj)
    _close_centered(K, ref, X)


@pytest.mark.parametrize("bf16", [False, True])
def test_gram_centered_device_is_gram_panel(sim_small, bf16):
    # Both modes are gram_panel's call (K2; a bf16 panel stays bf16), bit for
    # bit, and within the schedules' 2e-5 of the JAX default (its gram_panel).
    X = torch.from_numpy(_panel(sim_small).astype(np.float32))
    if bf16:
        X = X.to(torch.bfloat16)
    K = grm_t.gram_panel(X, device=CPU)
    for use_pallas in (False, True):
        assert torch.equal(grm_t.gram_centered_device(X, use_pallas=use_pallas, device=CPU), K)
    Xj = X.float().numpy()
    _close_centered(K, grm_jax.gram_centered_device(jnp.asarray(Xj, jnp.bfloat16) if bf16 else Xj), X)


def test_gram_schedules_cuda_without_cuda_raise(sim_small):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: device='cuda' is valid here")
    X = _panel(sim_small)
    for fn in (grm_t.gram_recursive, grm_t.gram_triangular, grm_t.gram_centered_device,
               grm_t.gram_centered_blocked):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(X)
