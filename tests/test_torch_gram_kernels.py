"""K1/K2 wrappers and plain versions held against the Pallas kernels
(interpret mode) and the XLA dosage Gram, plus the wrappers' contract.

The CUDA kernels themselves run only on the card: see
tests/test_torch_cuda_kernels.py.
"""

import numpy as np
import pytest
import torch

from genomicbreedingmodels_tpu.ops.grm import gram_dosage as gram_dosage_jax
from genomicbreedingmodels_tpu.ops.pallas_kernels import grm_pallas, grm_pallas_int8
from genomicbreedingmodels_tpu_torch.kernels import gram_tri
from genomicbreedingmodels_tpu_torch.ops.grm import gram_dosage

torch.set_num_threads(2)

SHAPES = [(64, 512), (100, 300), (129, 257)]


def _dosages(n, p, ploidy=2, seed=1):
    return np.random.default_rng(seed).integers(0, ploidy + 1, size=(n, p)).astype(np.int8)


@pytest.mark.parametrize("n,p", SHAPES)
def test_int8_plain_matches_pallas_and_xla(n, p):
    D = _dosages(n, p)
    L = gram_tri.gram_tri_int8(torch.from_numpy(D), ploidy=2)
    assert L.dtype == torch.int32 and L.shape == (n, n)
    L = L.numpy()
    assert not np.triu(L, 1).any()  # strict upper triangle exactly zero
    exact = D.astype(np.int64) @ D.T.astype(np.int64)
    # The JAX paths return G/k² in f32; ×k² is exact (integers below 2²⁴).
    pallas = np.asarray(grm_pallas_int8(D, ploidy=2, tm=32, tk=128, center=False)) * 4
    xla = np.asarray(gram_dosage_jax(D, ploidy=2, center=False)) * 4
    for ref in (exact, pallas, xla):
        assert np.array_equal(L, np.tril(ref).astype(np.int64))
    M = L + np.tril(L, -1).T
    assert np.array_equal(M, M.T)


@pytest.mark.parametrize("ploidy", [1, 4, 127])
def test_int8_plain_chunking_exact(ploidy):
    # ploidy 127 forces 1040-column float32 chunks in the plain version.
    D = _dosages(40, 3000, ploidy=ploidy, seed=ploidy)
    L = gram_tri.gram_tri_int8_plain(torch.from_numpy(D), ploidy).numpy()
    exact = D.astype(np.int64) @ D.T.astype(np.int64)
    assert np.array_equal(L, np.tril(exact))


@pytest.mark.parametrize("n,p", SHAPES)
def test_float_plain_matches_pallas(n, p):
    X = np.random.default_rng(0).random((n, p)).astype(np.float32)
    L = gram_tri.gram_tri_float(torch.from_numpy(X))
    assert L.dtype == torch.float32 and L.shape == (n, n)
    L = L.numpy()
    assert not np.triu(L, 1).any()
    G = np.asarray(grm_pallas(X, center=False))
    assert np.abs(L - np.tril(G)).max() <= 1e-5 * np.abs(G).max()


def test_float_plain_takes_bf16():
    X = torch.rand(33, 70, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    L = gram_tri.gram_tri_float(X)
    Xd = X.double()
    assert torch.allclose(L.double(), torch.tril(Xd @ Xd.T), rtol=1e-6, atol=0)


def test_wrappers_reject_bad_inputs():
    D = torch.zeros(4, 8, dtype=torch.int8)
    with pytest.raises(TypeError):
        gram_tri.gram_tri_int8(D.float())
    with pytest.raises(TypeError):
        gram_tri.gram_tri_int8(D.numpy())
    with pytest.raises(ValueError, match="2-D"):
        gram_tri.gram_tri_int8(D.reshape(2, 2, 8))
    with pytest.raises(ValueError, match="contiguous"):
        gram_tri.gram_tri_int8(D.T)
    with pytest.raises(ValueError, match="ploidy"):
        gram_tri.gram_tri_int8(D, ploidy=0)
    with pytest.raises(TypeError):
        gram_tri.gram_tri_float(D)
    with pytest.raises(TypeError):
        gram_tri.gram_tri_float(torch.zeros(4, 8, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        gram_tri.gram_tri_float(torch.zeros(8, 4).T)
    with pytest.raises(TypeError, match="int8"):
        gram_dosage(np.zeros((4, 8), np.float32), device="cpu")


def test_int32_overflow_guard_raises():
    # p·ploidy² >= 2³¹ with p = 133200, ploidy = 127: must raise, not wrap.
    D = torch.zeros(2, 133_200, dtype=torch.int8)
    with pytest.raises(ValueError, match="2³¹"):
        gram_tri.gram_tri_int8(D, ploidy=127)
    gram_tri.gram_tri_int8(D[:, :133_000].contiguous(), ploidy=127)  # just below: fine


def test_plain_versions_do_not_count_launches():
    gram_tri.reset_launches()
    gram_tri.gram_tri_int8(torch.zeros(3, 5, dtype=torch.int8))
    gram_tri.gram_tri_float(torch.zeros(3, 5))
    assert gram_tri.LAUNCHES == {"gram_tri_int8": 0, "gram_tri_float": 0, "gibbs_group": 0}


def test_cuda_requested_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        gram_dosage(_dosages(4, 8))
