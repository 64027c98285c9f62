"""The port's accuracy-parity ledger (genomicbreedingmodels_tpu_torch/parity.py)
on the CPU: every quick row passes its threshold, and the rows, quantities
and thresholds are the JAX ledger's."""

import genomicbreedingmodels_tpu_torch.parity as parity_t
from genomicbreedingmodels_tpu.parity import run_parity_ledger as run_parity_ledger_jax


def test_quick_ledger_passes_on_the_cpu():
    lines = []
    rows = parity_t.run_parity_ledger(emit=lines.append, quick=True, device="cpu")
    assert len(lines) == len(rows) == 5
    for r in rows:
        assert r["pass"] and r["value"] >= r["threshold"], r


def test_rows_and_thresholds_match_the_jax_ledger():
    mine = parity_t.run_parity_ledger(emit=lambda s: None, quick=True, device="cpu")
    theirs = run_parity_ledger_jax(emit=lambda s: None, quick=True)
    assert [(r["model"], r["quantity"], r["threshold"]) for r in mine] == \
        [(r["model"], r["quantity"], r["threshold"]) for r in theirs]
