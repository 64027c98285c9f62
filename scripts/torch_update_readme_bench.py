"""Regenerate README.md's table of the port's bench from a bench_torch.py run.

The twin of scripts/update_readme_bench.py for `bench_torch.py`: reads the
run's output (stdout and stderr together, `python3 bench_torch.py > f 2>&1`),
takes the card's name and power limit from its `# card:` note and each
metric's last line, and rewrites the table between README's
`<!-- torch-bench:begin -->` and `<!-- torch-bench:end -->` markers, one row
per metric, each naming the card. SNPs/s are written as `9.3e10 SNPs/s`
(README's own test counts the `GSNP/s` claims outside the JAX bench block).

Usage: python scripts/torch_update_readme_bench.py [RUN]   (default: RECORDED)
"""

import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
README = ROOT / "README.md"
RECORDED = "BENCH_TORCH_r01.txt"  # the full run on the card that README's block shows


def parse_run(text: str):
    """(card as "name, power limit", {metric: line}) of a bench_torch.py output."""
    card = None
    metrics = {}
    for ln in text.splitlines():
        ln = ln.strip()
        if card is None and ln.startswith("# card: "):
            card = ", ".join(ln[len("# card: "):].split(";")[0].split(", ")[:2])
        elif ln.startswith("{"):
            try:
                m = json.loads(ln)
            except json.JSONDecodeError:
                continue
            if isinstance(m, dict) and {"metric", "value", "unit"} <= m.keys():
                metrics[m["metric"]] = m
    return card, metrics


def fmt(m) -> str:
    v, u = m["value"], m["unit"]
    if u in ("SNPs/s", "updates/s", "pairs/s"):
        mantissa, exp = f"{v:.2e}".split("e")
        return f"**{mantissa}e{int(exp)} {u}**"
    if u in ("markers/s", "MB/s"):
        return f"**{v:,.0f} {u}**"
    if u == "ESS/s":
        return f"**{v:.1f} ESS/s**"
    if u == "s":
        return f"**{v:.3f} s**"
    return f"**{v:.4g} {u}**"


def table(card: str, metrics: dict) -> str:
    rows = "\n".join(f"| {name} | {fmt(m)} | {card} |" for name, m in metrics.items())
    return f"| benchmark (bench_torch.py metric) | result | card, power limit |\n|---|---|---|\n{rows}"


def main(argv) -> int:
    card, metrics = parse_run((ROOT / (argv[0] if argv else RECORDED)).read_text())
    if not metrics or card is None:
        sys.exit("no metric lines or no '# card:' note in the given run")
    new, count = re.subn(
        r"<!-- torch-bench:begin -->.*?<!-- torch-bench:end -->",
        lambda _mo: f"<!-- torch-bench:begin -->\n{table(card, metrics)}\n<!-- torch-bench:end -->",
        README.read_text(), flags=re.S)
    if count == 0:
        sys.exit("README.md has no <!-- torch-bench:begin/end --> markers")
    README.write_text(new)
    print(f"README.md: wrote {len(metrics)} rows from the run on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
