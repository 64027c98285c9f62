"""No process the benchmark starts loads JAX or the JAX package, compared by
whole top-level names (the port's name begins with the JAX package's)."""

import subprocess
import sys

import pytest
from conftest import BENCH, TINY

import harness


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "genomicbreedingmodels_tpu",
                 "genomicbreedingmodels_tpu.ops"):
        monkeypatch.setitem(sys.modules, name, object())
    for name in ("jaxtyping", "genomicbreedingmodels_tpu_torch_extra", "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
    got = harness.forbidden_loaded()
    assert "jaxtyping" not in got and "flaxen" not in got
    assert "genomicbreedingmodels_tpu_torch_extra" not in got
    assert {"jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "genomicbreedingmodels_tpu",
            "genomicbreedingmodels_tpu.ops"} <= set(got)


# The registered cells; a tiny file that comes before its cell is registered
# (cv-bayes) is run without JAX by test_bench_chain.py.
@pytest.mark.parametrize("workload", sorted(set(TINY) & {w["name"] for w in harness.load_manifest()["workloads"]}))
@pytest.mark.parametrize("trace", [0, 1])
def test_a_cpu_run_loads_no_jax(workload, trace):
    code = (
        "import sys, time; t0 = time.perf_counter(); sys.path[:0] = [%r, %r]; "
        "from conftest import TINY; import run, harness; "
        "rc = run.main(['--workload', %r, '--seed', '5', '--seconds', '0.2', '--trace', '%d'], "
        "require_chip=False, device='cpu', config_overrides=TINY[%r][0], traffic_overrides=TINY[%r][1], t0=t0); "
        "print('FORBIDDEN', harness.forbidden_loaded()); "
        "print('PORT', 'genomicbreedingmodels_tpu_torch' in sys.modules); sys.exit(rc)"
    ) % (str(BENCH / "tests"), str(BENCH), workload, trace, workload, workload)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                       cwd=BENCH.parent)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "FORBIDDEN []" in r.stdout and "PORT True" in r.stdout


def test_the_run_refuses_a_loaded_jax(monkeypatch, capsys):
    """A run that finds a forbidden module once its window has closed exits 3
    and prints no result."""
    from conftest import run_tiny

    monkeypatch.setitem(sys.modules, "jax", object())
    rc, res = run_tiny("gblup-refit-int8")
    assert rc == 3 and res is None
