"""Out-of-core workflow on the PyTorch port: write a PLINK .bed panel, then
go disk → GRM → GEBV without ever materializing the panel in memory
(streaming.py). The twin of examples/out_of_core.py.

Run: python examples/torch_out_of_core.py [--device cuda|cpu]
(`--device` defaults to cuda, and asking for cuda without a card raises.)

The panel is written under a temporary directory, removed at the end. Its
calls are complete, so every shard reaches the GRM as int8 dosages (K1 on
the card).
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import genomicbreedingmodels_tpu_torch as gbm  # noqa: E402
from genomicbreedingmodels_tpu_torch.device import resolve_device  # noqa: E402


def main(device="cuda", n: int = 500, p: int = 20_000, block_cols: int = 4096,
         lam: float = 0.2) -> dict:
    """Writes, streams and fits the panel on `device`; returns the GEBVs, the
    shard count, the GRM's shape and mean diagonal and cor(GEBV, y)."""
    resolve_device(device)
    rng = np.random.default_rng(0)
    # .bed stores 2-bit dosages: simulate diploid allele frequencies {0, .5, 1}
    F = rng.choice([0.0, 0.5, 1.0], size=(n, p), p=[0.3, 0.4, 0.3])
    genomes = gbm.Genomes(
        entries=np.array([f"e{i}" for i in range(n)], dtype=object),
        populations=np.array(["pop1"] * n, dtype=object),
        loci_alleles=np.array([f"chr1\t{j+1}\tA|T\tA" for j in range(p)], dtype=object),
        allele_frequencies=F,
    )
    b = rng.normal(size=p) * (rng.random(p) < 0.01)
    y = F @ b + 0.5 * rng.normal(size=n)

    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        gbm.write_bed(genomes, d / "panel")
        bed_mb = (d / "panel.bed").stat().st_size / 1e6
        print(f"wrote {d/'panel'}.bed ({bed_mb:.1f} MB)")

        # Stream shards with background prefetch; GRM accumulates shard-by-shard.
        streamer = gbm.BedShardStreamer(d / "panel", block_cols=block_cols, prefetch=2)
        print(f"{len(streamer)} shards of <={block_cols} markers, n={streamer.n}")

        gebv, K = gbm.gblup_from_bed(d / "panel", y, lam=lam, block_cols=block_cols,
                                     device=device)
        gebv = gebv.cpu().numpy()
        K = K.cpu().numpy()
    mean_diag = float(np.mean(np.diag(K)))
    cor = float(np.corrcoef(gebv, y)[0, 1])
    print(f"GRM {K.shape}, mean diag {mean_diag:.3f}")
    print(f"GEBV vs y correlation: {cor:.3f}")
    return dict(gebv=gebv, y=y, n_shards=len(streamer), grm_shape=K.shape, mean_diag=mean_diag,
                cor=cor, bed_mb=bed_mb)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    main(device=ap.parse_args().device)
