"""The port's ops/linalg.py held against the JAX package's on the same numpy
inputs (the sim_small panel, split 90/10): fold masks and λ grids bit for
bit, min-norm least squares, the ridge and lasso CV paths, the bf16 product
and the lasso screen's tie order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genomicbreedingmodels_tpu.ops import linalg as lj
from genomicbreedingmodels_tpu_torch.ops import linalg as lt

torch.set_num_threads(2)
CPU = "cpu"


def _xy(sim_small, rows=90):
    genomes, phenomes, _ = sim_small
    return genomes.allele_frequencies[:rows], phenomes.phenotypes[:rows, 0]


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b))


@pytest.mark.parametrize("n,k,seed", [(100, 10, 42), (37, 3, 1), (5, 5, 0), (2048, 5, 7)])
def test_make_fold_masks_bit_identical(n, k, seed):
    m = lt.make_fold_masks(n, k, seed)
    assert m.dtype == np.float32 and np.array_equal(m, lj.make_fold_masks(n, k, seed))


@pytest.mark.parametrize("alpha", [0.0, 1.0, 0.5])
def test_make_lambda_grid(sim_small, alpha):
    """numpy input: bit-identical (one float64 code path); a tensor takes an
    f32 GEMV, as a jax array does in the JAX package: rtol 1e-5."""
    X, y = _xy(sim_small)
    g = lt.make_lambda_grid(X, y, 20, 0.01, alpha=alpha)
    assert np.array_equal(g, lj.make_lambda_grid(X, y, 20, 0.01, alpha=alpha))
    gt = lt.make_lambda_grid(torch.tensor(X, dtype=torch.float32), y, 20, 0.01, alpha=alpha)
    gj = lj.make_lambda_grid(jnp.asarray(X, jnp.float32), y, 20, 0.01, alpha=alpha)
    np.testing.assert_allclose(gt, gj, rtol=1e-5)


def _complementary_tall(rng, n=60, m=12):
    """A tall, rank-deficient design: intercept plus both alleles of m loci
    (x and 1 - x), so the columns sum to dependent sets."""
    x = rng.integers(0, 3, size=(n, m)) / 2.0
    return np.concatenate([np.ones((n, 1)), x, 1.0 - x], axis=1)


def test_lstsq_minnorm_matches_jax(sim_small):
    """Wide (dual eigh path) and tall (SVD path, rank-deficient and full
    rank). Tolerances: on the tall ones, fitted values within 1e-4·std(y)
    and coefficients within relative norm 1e-3; on the wide one 1e-2 for
    both, and each package within 1e-2 of the float64 min-norm solution: its
    dual solve divides by the eigenvalues of a float32 Gram of condition
    ~1.4e4, so both packages interpolate y only to ~5e-3."""
    X, y = _xy(sim_small)
    rng = np.random.default_rng(3)
    cases = [(np.c_[np.ones(len(y)), X], y, 1e-2),
             (np.c_[np.ones(len(y)), X[:, :40]], y, 1e-4),
             (_complementary_tall(rng), rng.normal(size=60), 1e-4)]
    for A, b, tol in cases:
        bt = lt.lstsq_minnorm(A, b, device=CPU)
        bj = lj.lstsq_minnorm(A, b)
        assert bt.dtype == np.float64 and bt.shape == (A.shape[1],)
        assert np.abs(A @ bt - A @ bj).max() <= tol * b.std()
        assert _rel(bt, bj) <= max(tol, 1e-3)
    A, b, _ = cases[0]
    ref = np.linalg.pinv(A) @ b
    assert np.abs(A @ lt.lstsq_minnorm(A, b, device=CPU) - A @ ref).max() <= 1e-2 * b.std()
    # the rank-deficient tall system: min-norm, so no weight leaks into the null space
    A, b, _ = cases[2]
    bt = lt.lstsq_minnorm(A, b, device=CPU)
    ref = np.linalg.pinv(A) @ b
    assert _rel(bt, ref) <= 1e-3


@pytest.mark.parametrize("n_folds,seed", [(3, 42), (5, 1)])
def test_ridge_cv_path_matches_jax(sim_small, n_folds, seed):
    """meanloss within rtol 1e-3, the same chosen λ, β within relative norm
    1e-3, the intercept within 1e-4·std(y)."""
    X, y = _xy(sim_small)
    b0t, bt, it = lt.ridge_cv_path(X, y, n_lambda=12, n_folds=n_folds, seed=seed, device=CPU)
    b0j, bj, ij = lj.ridge_cv_path(X, y, n_lambda=12, n_folds=n_folds, seed=seed)
    np.testing.assert_allclose(it["meanloss"], ij["meanloss"], rtol=1e-3)
    assert it["chosen"] == ij["chosen"]
    np.testing.assert_allclose(it["lambdas"], ij["lambdas"], rtol=1e-5)  # both from an f32 GEMV
    assert _rel(bt, bj) <= 1e-3
    assert abs(b0t - b0j) <= 1e-4 * y.std()


def test_ridge_cv_path_config_defaults(sim_small, monkeypatch):
    """Path defaults flow from GBMConfig as in the JAX package."""
    from genomicbreedingmodels_tpu_torch.utils import config

    X, y = _xy(sim_small, rows=40)
    config.set_config(config.GBMConfig(n_lambda=7, path_cv_folds=4))
    try:
        _, _, info = lt.ridge_cv_path(X, y, device=CPU)
    finally:
        config.reset_config()
    assert len(info["lambdas"]) == 7 and len(info["meanloss"]) == 7


@pytest.mark.parametrize("screen_factor", [0, 4])
def test_lasso_cv_path_matches_jax(sim_small, screen_factor):
    """Unscreened and screened (p = 1000 > 4·90: the top 1024 → all 1000
    markers, so `screen_factor=4` also runs the screen's gather). Tolerance:
    fitted values correlate ≥ 0.999; the same chosen λ."""
    X, y = _xy(sim_small)
    kw = dict(n_lambda=8, n_folds=3, n_iter=200, screen_factor=screen_factor)
    b0t, bt, it = lt.lasso_cv_path(X, y, device=CPU, **kw)
    b0j, bj, ij = lj.lasso_cv_path(X, y, **kw)
    assert it["screened_to"] == ij["screened_to"]
    assert it["chosen"] == ij["chosen"]
    assert np.corrcoef(b0t + X @ bt, b0j + X @ bj)[0, 1] >= 0.999


def test_lasso_screen_keeps_top_k_tie_order():
    """Tied marginal scores (duplicated columns): the port's stable
    descending sort keeps the lower index first, as jax.lax.top_k does."""
    rng = np.random.default_rng(5)
    base = rng.integers(0, 3, size=(30, 8)) / 2.0
    X = np.concatenate([base, base, base[:, ::-1]], axis=1).astype(np.float32)
    y = rng.normal(size=30).astype(np.float32)
    w = np.ones(30, np.float32)
    k = 11
    s_t = lt._sis_scores(torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(w))
    idx_t = torch.sort(s_t, descending=True, stable=True).indices[:k].numpy()
    _, idx_j = jax.lax.top_k(lj._sis_scores(jnp.asarray(X), jnp.asarray(y), jnp.asarray(w)), k)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(lj._sis_scores(X, y, w)), rtol=1e-5)
    assert np.array_equal(idx_t, np.asarray(idx_j))


def test_mm_bf16_is_f32_product_of_rounded_operands():
    """On a CPU tensor the bf16 product is the float32 product of the
    bf16-rounded operands: every elementwise product is exact in float32."""
    g = torch.Generator().manual_seed(0)
    a = torch.rand((17, 33), generator=g).to(torch.bfloat16)
    b = torch.rand((33, 5), generator=g).to(torch.bfloat16)
    out = lt._mm_bf16(a, b)
    assert out.dtype == torch.float32
    assert torch.equal(out, a.float() @ b.float())
    ref = np.asarray(jnp.dot(jnp.asarray(a.float().numpy(), jnp.bfloat16),
                             jnp.asarray(b.float().numpy(), jnp.bfloat16),
                             preferred_element_type=jnp.float32))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6)


def test_lasso_fista_batch_matches_jax(sim_small):
    """One FISTA batch on the same centered design, step and λ: the bf16
    bulk and the f32 polish leg of both packages, coefficients within
    1e-3 relative norm."""
    X, y = _xy(sim_small)
    Z = (X - X.mean(0)).astype(np.float32)
    yc = (y - y.mean()).astype(np.float32)
    w = np.ones(len(y), np.float32)
    lams = lj.make_lambda_grid(X, y, 6, 0.05, alpha=1.0).astype(np.float32)
    step = np.float32(1.0 / (float(lj._power_iter_lmax(jnp.asarray(Z))) / len(y)))
    Bj = np.asarray(lj._lasso_fista_batch(jnp.asarray(Z), jnp.asarray(yc), jnp.asarray(w),
                                          jnp.asarray(lams), jnp.float32(step), 160))
    Bt = lt._lasso_fista_batch(torch.from_numpy(Z), torch.from_numpy(yc), torch.from_numpy(w),
                               torch.from_numpy(lams), torch.tensor(step), 160).numpy()
    assert _rel(Bt, Bj) <= 1e-3


def test_power_iter_lmax_finds_the_top_eigenvalue(sim_small):
    """The step-size estimate on a centered panel, whose Gram has the
    constant vector in its null space: within 1e-3 of float64's top
    eigenvalue, on full and on fold-masked rows (the reference starts from
    the constant vector and lands where float32 rounding takes it)."""
    X, _ = _xy(sim_small)
    w = lt.make_fold_masks(len(X), 3, 0)[0].astype(np.float64)
    for rows in (np.ones(len(X)), w):
        mean = (rows[:, None] * X).sum(0) / rows.sum()
        Zw = (rows[:, None] * (X - mean)).astype(np.float32)
        top = np.linalg.eigvalsh(Zw.astype(np.float64) @ Zw.T.astype(np.float64))[-1]
        assert float(lt._power_iter_lmax(torch.from_numpy(Zw))) == pytest.approx(top, rel=1e-3)
