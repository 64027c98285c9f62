"""The port's blocked Cholesky, blocked substitution and GBLUP solve
(genomicbreedingmodels_tpu_torch/ops/chol.py) held against their JAX twins
(genomicbreedingmodels_tpu/ops/chol.py) and float64 references, the twins of
tests/test_chol.py's cases. Tolerances: 1e-5·max against JAX (both float32,
the same panels and products); 5e-4·max|L| and 2e-3·max|x| against float64,
as the JAX tests hold the JAX functions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genomicbreedingmodels_tpu.ops import chol as chol_jax
from genomicbreedingmodels_tpu.ops.grm import encode_dosage, gram_dosage_lower as gram_lower_jax
from genomicbreedingmodels_tpu_torch.ops import chol
from genomicbreedingmodels_tpu_torch.ops.grm import gram_dosage_lower

torch.set_num_threads(2)
CPU = "cpu"


def _psd(n, seed=0):
    rng = np.random.default_rng(seed)
    B = rng.normal(size=(n, n + 8)).astype(np.float32)
    return (B @ B.T / n + np.eye(n, dtype=np.float32)).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("n,nb", [(256, 4), (100, 16), (128, 1), (96, 7)])
def test_blocked_cholesky_matches_jax_and_float64(n, nb):
    A = _psd(n)
    L = chol.blocked_cholesky(A, nb=nb, device=CPU)
    assert L.dtype == torch.float32 and L.shape == (n, n)
    L = L.numpy()
    assert np.array_equal(np.tril(L), L)  # strict upper triangle zero
    assert _rel(L, chol_jax.blocked_cholesky(jnp.asarray(A), nb=nb)) <= 1e-5
    assert _rel(L, np.linalg.cholesky(A.astype(np.float64))) <= 5e-4


def test_blocked_cholesky_reads_lower_triangle_only():
    A = _psd(192, seed=1)
    junk = A.copy()
    junk[np.triu_indices(192, 1)] = 777.0
    L1 = chol.blocked_cholesky(A, nb=6, device=CPU)
    assert torch.equal(L1, chol.blocked_cholesky(junk, nb=6, device=CPU))


@pytest.mark.parametrize("n,nb", [(256, 4), (100, 16)])
def test_blocked_cho_solve_matches_jax_and_float64(n, nb):
    A = _psd(n, seed=2)
    y = np.random.default_rng(3).normal(size=n).astype(np.float32)
    x = chol.blocked_cho_solve(A, y, nb=nb, device=CPU).numpy()
    assert _rel(x, chol_jax.blocked_cho_solve(jnp.asarray(A), jnp.asarray(y), nb=nb)) <= 1e-5
    assert _rel(x, np.linalg.solve(A.astype(np.float64), y.astype(np.float64))) <= 2e-3


@pytest.mark.parametrize("lam_per_marker", [0.1, 1.0])
def test_gblup_solve_lower_blocked_matches_jax(sim_small, lam_per_marker):
    # The headline's system: a K1 Gram of called dosages, λ per marker on the raw scale.
    D = encode_dosage(np.rint(2.0 * sim_small[0].allele_frequencies) / 2.0)
    y = sim_small[1].phenotypes[:, 0].astype(np.float32)
    lam = lam_per_marker * D.shape[1]
    gebv = chol.gblup_solve_lower(gram_dosage_lower(D, device=CPU), torch.from_numpy(y), lam, nb=16)
    ref = chol_jax.gblup_solve_lower(gram_lower_jax(D), jnp.asarray(y), jnp.float32(lam), nb=16)
    assert _rel(gebv.numpy(), ref) <= 1e-5


def _solve_lower_before(K_lower, y, lam):
    """gblup_solve_lower's body before the blocked solver was ported."""
    n = K_lower.shape[0]
    mu = y.mean()
    yc = y - mu
    A = torch.tril(K_lower) + torch.tril(K_lower, -1).T
    A.diagonal().add_(lam)
    L, _ = torch.linalg.cholesky_ex(A)
    alpha = torch.cholesky_solve(yc.reshape(n, 1), L).reshape(n)
    return yc - lam * alpha + mu


def test_gblup_solve_lower_default_path_unchanged(sim_small):
    D = encode_dosage(np.rint(2.0 * sim_small[0].allele_frequencies) / 2.0)
    K = gram_dosage_lower(D, device=CPU)
    y = torch.from_numpy(sim_small[1].phenotypes[:, 0].astype(np.float32))
    lam = 0.1 * D.shape[1]
    gebv = chol.gblup_solve_lower(K, y, lam)
    assert torch.equal(gebv, _solve_lower_before(K, y, lam))
    # the blocked solver gives the same GEBVs to float32 rounding
    assert _rel(chol.gblup_solve_lower(K, y, lam, nb=8).numpy(), gebv.numpy()) <= 1e-5


@pytest.mark.parametrize("nb", [None, 4, 16])
def test_not_positive_definite_gives_non_finite(nb):
    # No host sync and no exception: every GEBV is non-finite, as every
    # GEBV of the JAX function is.
    A = _psd(64, seed=4)
    A[40, 40] = -5.0
    y = np.random.default_rng(5).normal(size=64).astype(np.float32)
    gebv = chol.gblup_solve_lower(torch.from_numpy(A), torch.from_numpy(y), 0.0, nb=nb)
    assert not bool(torch.isfinite(gebv).any())
    ref = chol_jax.gblup_solve_lower(jnp.asarray(A), jnp.asarray(y), jnp.float32(0.0), nb=nb or 16)
    assert not np.isfinite(np.asarray(ref)).any()
    if nb is not None:
        assert not bool(torch.isfinite(chol.blocked_cholesky(A, nb=nb, device=CPU)).all())


def test_blocked_cuda_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        chol.blocked_cholesky(_psd(8))
    with pytest.raises(RuntimeError, match="CUDA"):
        chol.blocked_cho_solve(_psd(8), np.ones(8, np.float32))
