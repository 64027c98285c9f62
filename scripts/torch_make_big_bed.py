"""Generate a north-star-scale PLINK .bed/.bim/.fam trio for the
disk-streamed GBLUP measurements (chip_smoke.py phase 15's "diskstream").
The twin of scripts/make_big_bed.py.

Thin CLI over `genomicbreedingmodels_tpu_torch.io.write_random_bed` —
complete diploid calls (missing code never appears, so the exact int8
dosage path of streaming.gblup_from_bed_pieces applies), spec-compliant
padding bits, and a minimal .bim so the trio loads in external tools; the
same bytes as scripts/make_big_bed.py writes for the same arguments. The
50k x 500k default is 6.25 GB of payload.

Usage: python scripts/torch_make_big_bed.py [prefix] [n] [p]
Defaults: /tmp/big_panel 50000 500000
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from genomicbreedingmodels_tpu_torch.io import write_random_bed  # noqa: E402


def main() -> None:
    prefix = sys.argv[1] if len(sys.argv) > 1 else "/tmp/big_panel"
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 50_000
    p = int(sys.argv[3]) if len(sys.argv) > 3 else 500_000
    write_random_bed(prefix, n, p, progress=True)
    total = ((n + 3) // 4) * p
    print(f"wrote {prefix}.bed ({total / 1e9:.2f} GB payload) + .bim + .fam (n={n}, p={p})")


if __name__ == "__main__":
    main()
