"""The benchmark's tests: run them with `python -m pytest benchmark/tests -q`
from the root of a checkout (CPU; tests marked `cuda` skip without a card).
They put the benchmark's folder and the checkout's root on `sys.path`, as
`benchmark/run.py` does."""

import json
import sys
import time
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

# Tiny sizes of each cell for CPU runs, {workload: (config overrides,
# traffic overrides)}, from `tiny/<workload>.json` ({"config": ..., "traffic": ...}):
# a cell's tests find its file by the cell's name.
TINY = {f.stem: (d["config"], d["traffic"])
        for f in sorted((BENCH / "tests" / "tiny").glob("*.json")) for d in [json.loads(f.read_text())]}


def run_tiny(workload: str, seed: int = 7, seconds: float = 0.3, trace: int = 0, config=None, traffic=None):
    """(exit code, last stdout line as a dict or None) of a CPU run of a cell
    at its tiny size, in this process; `config` and `traffic` override more."""
    import io
    from contextlib import redirect_stdout

    import run

    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)], require_chip=False, device="cpu",
                      config_overrides={**TINY[workload][0], **(config or {})},
                      traffic_overrides={**TINY[workload][1], **(traffic or {})},
                      t0=time.perf_counter())
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    return rc, (json.loads(lines[-1]) if lines else None)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control's TF32 products exist only there")
    return torch.device("cuda", 0)
