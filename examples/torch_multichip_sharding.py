"""Multi-device sharding demo on the PyTorch port: marker-sharded GRM, ridge,
and Gibbs. The twin of examples/multichip_sharding.py.

Run: python examples/torch_multichip_sharding.py [--device cuda|cpu] [--ranks D]
(`--device` defaults to cuda, and asking for cuda without a card raises.)

The D ranks (default 2) are threads of this one process over gloo groups
(`parallel/mesh.py:run_ranks`), all on the one device named: on a card each
collective is staged through the host and the ranks' kernels take turns on
its stream. So this example checks correctness (every rank gets the same
bits back, and the sharded GRM is the single-device one), not scaling. A
deployment runs one process per card over NCCL instead: `torchrun
--nproc-per-node 4 job.py`, where the job calls
`parallel.distributed.distributed_init()` and then
`parallel.distributed.make_multihost_mesh()` and hands that mesh to the
same sharded functions.

Besides the JAX example's float GRM (K2 per rank on a card), the panel
called to diploid dosages goes through the int8 sharded GRM (K1 per rank).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import genomicbreedingmodels_tpu_torch as gbm  # noqa: E402
from genomicbreedingmodels_tpu_torch.device import resolve_device  # noqa: E402
from genomicbreedingmodels_tpu_torch.ops.grm import encode_dosage  # noqa: E402
from genomicbreedingmodels_tpu_torch.parallel.mesh import run_ranks  # noqa: E402
from genomicbreedingmodels_tpu_torch.parallel.sharded import (  # noqa: E402
    sharded_gibbs_regression,
    sharded_grm,
    sharded_ridge_step,
)


def main(device="cuda", n: int = 128, l: int = 400, ranks: int = 2, n_iter: int = 300,
         n_burnin: int = 100) -> dict:
    """Runs the sharded GRM (float and int8), ridge step and BayesC chain on
    `ranks` thread ranks of `device`; returns rank 0's results, whether
    every rank returned the same bits, and the fit cor as printed."""
    dev = resolve_device(device)
    print(f"{ranks} ranks: {dev.type} (threads over gloo on one device)")

    genomes = gbm.simulate_genomes(n=n, l=l, seed=0)
    trials, _ = gbm.simulate_trials(genomes, f_add_dom_epi=np.array([[0.5, 0.05, 0.05]]), seed=0)
    phenomes = gbm.extract_phenomes(trials)
    X = np.asarray(genomes.allele_frequencies, np.float32)
    y = np.asarray(phenomes.phenotypes[:, 0], np.float32)
    D8 = encode_dosage(np.rint(2.0 * X) / 2.0)  # the panel called to int8 dosages

    def rank(mesh):
        K = sharded_grm(X, mesh)  # Gram partials all-reduced over the mesh
        K8 = sharded_grm(D8, mesh)
        b0, beta = sharded_ridge_step(X, y, lam=0.1, mesh=mesh)
        mu, b = sharded_gibbs_regression(X, y, mesh, model="BayesC", n_iter=n_iter,
                                         n_burnin=n_burnin)
        return K.cpu(), K8.cpu(), b0.cpu(), beta.cpu(), mu, b

    outs = run_ranks(rank, shape=(1, ranks), device=device)
    K, K8, b0, beta, mu, b = outs[0]
    same = all(torch.equal(o[i], outs[0][i]) for o in outs for i in range(4)) and all(
        o[4] == mu and np.array_equal(o[5], b) for o in outs)
    print("sharded GRM:", tuple(K.shape), "| int8 dosages:", tuple(K8.shape))
    print("sharded ridge: beta sharded over mesh ->", tuple(beta.shape))
    yhat = mu + X @ b
    fit_cor = float(np.corrcoef(yhat, y)[0, 1])
    print(f"sharded BayesC Gibbs: fit cor = {fit_cor:.3f}")
    print(f"every rank returned the same bits: {same}")
    return dict(K=K.numpy(), K_dosage=K8.numpy(), b0=float(b0), beta=beta.numpy(), mu=float(mu),
                b_hat=np.asarray(b), fit_cor=fit_cor, ranks_equal=same, ranks=ranks, X=X,
                dosages=D8)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--ranks", type=int, default=2, help="thread ranks on the one device")
    args = ap.parse_args()
    main(device=args.device, ranks=args.ranks)
