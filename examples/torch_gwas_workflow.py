"""GWAS workflow on the PyTorch port: prep, three scan flavors, Manhattan
plots. The twin of examples/gwas_workflow.py.

Run: python examples/torch_gwas_workflow.py [--device cuda|cpu] [--plots DIR]
(`--device` defaults to cuda, and asking for cuda without a card raises.)

The scans never depend on `--plots`: only with it does `plot_manhattan`
import matplotlib and write DIR/<scan>_manhattan.png.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import genomicbreedingmodels_tpu_torch as gbm  # noqa: E402
from genomicbreedingmodels_tpu_torch.device import resolve_device  # noqa: E402

SCANS = (("gwasols", "t"), ("gwaslmm", "normal"), ("gwasreml", "normal"))


def main(device="cuda", n: int = 200, l: int = 1_500, n_founders: int = 24, n_qtl: int = 10,
         plots=None) -> dict:
    """Runs the three scans on `device`; returns per scan its effect estimates
    (`b_hat`), the top-20 markers by |b_hat|, and the direct and tagging
    causal counts among them, as printed."""
    resolve_device(device)
    genomes = gbm.simulate_genomes(n=n, l=l, n_founders=n_founders, seed=7)
    trials, effects = gbm.simulate_trials(
        genomes, f_add_dom_epi=np.array([[0.7, 0.0, 0.0]]), n_qtl=n_qtl, seed=7
    )
    phenomes = gbm.extract_phenomes(trials)
    causal = set(effects[0].idx_additive.tolist())

    X = np.asarray(genomes.allele_frequencies)
    causal_idx = effects[0].idx_additive
    out = {}
    for name, dist in SCANS:
        fit = getattr(gbm, name)(genomes=genomes, phenomes=phenomes, device=device)
        b_hat = np.asarray(fit.b_hat)
        top = np.argsort(-np.abs(b_hat))[:20]
        direct = len(set(top.tolist()) & causal)
        # GWAS on an LD panel tags causal loci through correlated proxies.
        R = np.corrcoef(X[:, top].T, X[:, causal_idx].T)[: len(top), len(top):]
        tagged = int((np.abs(R).max(axis=1) > 0.5).sum())
        print(f"{name:9s} top-20: {direct} direct causal, {tagged} tagging (|r|>0.5)")
        if plots is not None:
            path = Path(plots) / f"{name}_manhattan.png"
            path.parent.mkdir(parents=True, exist_ok=True)
            gbm.plot_manhattan(fit, dist=dist, save_path=str(path))
            print(f"          Manhattan plot -> {path}")
        out[name] = dict(b_hat=b_hat, top20=top.tolist(), direct=direct, tagged=tagged)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--plots", default=None, metavar="DIR",
                    help="write each scan's Manhattan plot under DIR (needs matplotlib)")
    args = ap.parse_args()
    main(device=args.device, plots=args.plots)
