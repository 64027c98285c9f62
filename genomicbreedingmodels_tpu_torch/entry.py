"""Driver entry points, torch twins of `__graft_entry__.py`: the flagship
model's forward step (`entry`) and the multi-rank dry run
(`dryrun_multichip`)."""

from __future__ import annotations

import numpy as np
import torch

from .device import as_tensor
from .ops.grm import gram_panel


def gblup_forward(X: torch.Tensor, y: torch.Tensor, lam) -> torch.Tensor:
    """GEBVs for all entries: the centered Gram K = Z Zᵀ / p (through
    `gram_panel`, hence K2 on the card), then (K + λI) α = y_c and K α + ȳ."""
    K = gram_panel(X, device=X.device) / X.shape[1]
    mu = y.mean()
    A = K + lam * torch.eye(K.shape[0], dtype=K.dtype, device=K.device)
    alpha = torch.linalg.solve(A, y - mu)
    return K @ alpha + mu


def entry(device="cuda"):
    """(fn, example_args): the GBLUP forward step and inputs on `device`,
    drawn from the same numpy seed as the JAX entry point."""
    rng = np.random.default_rng(0)
    X = as_tensor(rng.random((256, 2048)), device, torch.float32)
    y = as_tensor(rng.normal(size=256), device, torch.float32)
    lam = torch.tensor(0.1, dtype=torch.float32, device=X.device)
    return gblup_forward, (X, y, lam)


def _factor_ranks(n_devices: int) -> tuple:
    """(dp, mp): mp as large as possible with dp >= 2 when the count allows,
    as `__graft_entry__.dryrun_multichip` factors its devices."""
    for cand in (2, 3):
        if n_devices % cand == 0 and n_devices // cand >= 2:
            return cand, n_devices // cand
    return 1, n_devices


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """One step of every mesh path over `n_devices` ranks on a ('dp', 'mp')
    mesh (dp·mp = n_devices, factored as the JAX dry run), tiny shapes, the
    ranks run as threads on `device` (parallel/mesh.py:run_ranks): the
    sharded GRM, ridge and multi-trait GBLUP steps, two sweeps of the
    marker-sharded BayesC chain, the sharded REML scan, the matrix-free CG
    over all ranks on 'mp', `cvbulk_batched` (ridge, lasso, bayesc) and
    `transform2` with folds or pair rows over the ranks. Raises if a rank
    fails or a shape is wrong."""
    from .core.structs import Genomes, Phenomes
    from .cv.batched import cvbulk_batched
    from .features.endofunctions import mult
    from .features.transform import transform2
    from .parallel.mesh import run_ranks
    from .parallel.sharded import (
        multitrait_gblup_step,
        sharded_gblup_cg,
        sharded_gibbs_regression,
        sharded_grm,
        sharded_gwasreml,
        sharded_ridge_step,
    )

    dp, mp = _factor_ranks(n_devices)
    rng = np.random.default_rng(0)
    n, p, t = 32, 16 * mp, 2 * dp
    X = rng.random((n, p)).astype(np.float32)
    Y = rng.normal(size=(t, n)).astype(np.float32)
    y = Y[0]
    genomes = Genomes(
        entries=np.array([f"e{i:03d}" for i in range(n)]),
        populations=np.array(["pop_1"] * n),
        loci_alleles=np.array([f"chr1\t{j}\tA|T\tA" for j in range(p)]),
        allele_frequencies=X.astype(np.float64),
    )
    phenomes = Phenomes(entries=genomes.entries, populations=genomes.populations,
                        traits=np.array(["t"]), phenotypes=y.astype(np.float64)[:, None])

    def rank(mesh) -> None:
        K = sharded_grm(X, mesh)
        assert K.shape == (n, n)
        _, beta = sharded_ridge_step(X, y, 0.1, mesh)
        assert beta.shape == (p,)
        assert multitrait_gblup_step(X, Y, 0.1, mesh).shape == (t, n)
        _, b_hat = sharded_gibbs_regression(X, y, mesh, axis="mp", model="BayesC", n_iter=2,
                                            n_burnin=0, block_size=8)
        assert b_hat.shape == (p,)
        K_gwas = K / max(float(K.diagonal().sum()) / n, 1e-6)
        assert sharded_gwasreml(X, y, K_gwas, mesh, n_grid=4, n_newton=2).shape == (p,)
        cvs, _ = cvbulk_batched(genomes, phenomes, models=("ridge", "lasso"), n_replications=1,
                                n_folds=max(2, dp), mesh=mesh, store_effects=False)
        assert len(cvs) >= 2
        cvs_b, _ = cvbulk_batched(genomes, phenomes, models=("bayesc",), n_replications=1,
                                  n_folds=max(2, dp), mesh=mesh, store_effects=False,
                                  mcmc_n_iter=4, mcmc_n_burnin=1)
        assert len(cvs_b) >= 2
        pairs = transform2(mult, genomes, phenomes, n_new_features_per_transformation=4,
                           mesh=mesh)
        assert pairs.allele_frequencies.shape[1] >= 1

    def cg_rank(mesh) -> None:
        # The matrix-free CG over every rank on the marker axis, as the JAX
        # dry run's (1, n_devices) single-process multihost mesh.
        _, gebv = sharded_gblup_cg(X, y, 0.1, mesh, axis="mp", n_iter=8)
        assert gebv.shape == (n,)

    run_ranks(rank, shape=(dp, mp), device=device)
    run_ranks(cg_rank, shape=(1, n_devices), device=device)
