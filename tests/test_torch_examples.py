"""The port's four examples (examples/torch_*.py) and its .bed generator
(scripts/torch_make_big_bed.py) on the CPU.

Each example runs through its `main(device="cpu", **sizes)` at a reduced
size in a fresh interpreter where `import jax` fails, and neither jax, the
JAX package nor pandas is imported there. What it returns is held against
the JAX example's pipeline on the same inputs, run here in-process:
held-out cor within 1e-4 (quickstart; gblup within 2e-3, ROADMAP C.3),
the CV jobs' tags and folds, the gwasols top-20 set outside ties,
GEBVs within 1e-4·max|GEBV| (out-of-core), the sharded GRMs within
1e-5·max|X·Xᵀ| (multichip). The generator writes the JAX script's bytes.
"""

import os
import pickle
import runpy
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import genomicbreedingmodels_tpu as gj
from genomicbreedingmodels_tpu.ops import grm as grm_jax

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("torch_quickstart", "torch_gwas_workflow", "torch_out_of_core",
            "torch_multichip_sharding")

# Run in the child before its last line: nothing of jax, the JAX package or
# pandas was imported.
_NO_JAX = textwrap.dedent("""
    loaded = [m for m, mod in sys.modules.items() if mod is not None]
    bad = [m for m in loaded if m.split(".")[0] in ("jax", "jaxlib", "genomicbreedingmodels_tpu",
                                                     "pandas")]
    assert not bad, f"imported {bad[:5]}"
""")


def _child(code: str, cwd: Path) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(cwd), env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return out


def _run_example(name: str, tmp_path: Path, **sizes):
    """`examples/<name>.py`'s main(device="cpu", **sizes) in a fresh
    interpreter without jax: (its returned dict, its stdout)."""
    dump = tmp_path / f"{name}.pkl"
    code = textwrap.dedent(f"""
        import pickle, sys
        sys.modules["jax"] = None
        sys.path.insert(0, {str(ROOT / "examples")!r})
        import torch
        torch.set_num_threads(2)
        import {name} as example
        out = example.main(device="cpu", **{sizes!r})
    """) + _NO_JAX + f"pickle.dump(out, open({str(dump)!r}, 'wb'))\n"
    stdout = _child(code, tmp_path).stdout
    with open(dump, "rb") as f:
        return pickle.load(f), stdout


def _cor(a, b) -> float:
    return float(np.corrcoef(np.asarray(a, float), np.asarray(b, float))[0, 1])


def test_quickstart_matches_jax_pipeline(tmp_path):
    n, l, n_train = 60, 300, 48
    out, stdout = _run_example("torch_quickstart", tmp_path, n=n, l=l, n_train=n_train,
                               n_replications=1)
    assert "CV accuracy (batched ridge engine):" in stdout
    for name in ("ols", "ridge", "lasso", "gblup", "bayesa", "mlp"):
        assert f"{name:8s} in-sample cor=" in stdout
        assert np.isfinite(out["held_out_cor"][name]) and np.isfinite(out["in_sample_cor"][name])
    # The JAX example's pipeline on the same simulated inputs.
    genomes = gj.simulate_genomes(n=n, l=l, n_populations=2, seed=42)
    trials, _ = gj.simulate_trials(genomes, f_add_dom_epi=np.array([[0.5, 0.05, 0.05]]),
                                   n_years=2, n_replications=2, seed=42)
    phenomes = gj.extract_phenomes(trials)
    train, test = list(range(n_train)), list(range(n_train, n))
    y = np.asarray(phenomes.phenotypes[:, 0], float)
    # gblup at 2e-3: here σ²ᵤ sits on its REML bound in both packages and σ²ₑ
    # follows each one's float32 rounding (0.189 against 0.145; ROADMAP C.3).
    for name, tol in (("ols", 1e-4), ("ridge", 1e-4), ("gblup", 2e-3)):
        fit = getattr(gj, name)(genomes=genomes, phenomes=phenomes, idx_entries=train)
        ref = _cor(gj.predict(fit, genomes, idx_entries=test), y[test])
        assert abs(out["held_out_cor"][name] - ref) <= tol, (name, out["held_out_cor"][name], ref)
    cvs, _ = gj.cvbulk_batched(genomes, phenomes, n_replications=1, n_folds=5)
    assert out["cv_tags"] == [(cv.fit.trait, cv.fit.model, cv.replication, cv.fold) for cv in cvs]
    assert out["cv_entries"] == [list(cv.validation_entries) for cv in cvs]
    ref_cor = np.array([cv.metrics["cor"] for cv in cvs])
    assert np.abs(np.array(out["cv_cor"]) - ref_cor).max() <= 1e-3
    (mean, std), = out["cv_summary"].values()
    assert abs(mean - ref_cor.mean()) <= 1e-3 and abs(std - ref_cor.std(ddof=1)) <= 1e-3


def test_gwas_workflow_matches_jax_pipeline(tmp_path):
    n, l = 120, 600
    out, stdout = _run_example("torch_gwas_workflow", tmp_path, n=n, l=l)
    assert "Manhattan" not in stdout  # no plots without plots=
    genomes = gj.simulate_genomes(n=n, l=l, n_founders=24, seed=7)
    trials, effects = gj.simulate_trials(genomes, f_add_dom_epi=np.array([[0.7, 0.0, 0.0]]),
                                         n_qtl=10, seed=7)
    phenomes = gj.extract_phenomes(trials)
    for name in ("gwasols", "gwaslmm", "gwasreml"):
        assert f"{name:9s} top-20:" in stdout
        assert np.all(np.isfinite(out[name]["b_hat"]))
    ref = np.abs(np.asarray(gj.gwasols(genomes=genomes, phenomes=phenomes).b_hat))
    mine = np.abs(out["gwasols"]["b_hat"])
    top_ref = set(np.argsort(-ref)[:20].tolist())
    top = set(out["gwasols"]["top20"])
    # Markers in one set only must tie with the 20th largest |b| of the reference.
    kth = np.sort(ref)[-20]
    for j in top ^ top_ref:
        assert abs(ref[j] - kth) <= 1e-5 * kth and abs(mine[j] - kth) <= 1e-5 * kth, j
    if top == top_ref:
        causal = set(effects[0].idx_additive.tolist())
        assert out["gwasols"]["direct"] == len(top_ref & causal)


def test_out_of_core_matches_jax_pipeline(tmp_path):
    n, p, block_cols, lam = 120, 3000, 1024, 0.2
    out, stdout = _run_example("torch_out_of_core", tmp_path, n=n, p=p, block_cols=block_cols,
                               lam=lam)
    assert f"{out['n_shards']} shards of <={block_cols} markers, n={n}" in stdout
    assert out["n_shards"] == 3 and out["grm_shape"] == (n, n)
    assert abs(out["mean_diag"] - 1.0) <= 1e-5
    # The JAX example's panel from the same generator, written and streamed by the JAX package.
    rng = np.random.default_rng(0)
    F = rng.choice([0.0, 0.5, 1.0], size=(n, p), p=[0.3, 0.4, 0.3])
    genomes = gj.Genomes(
        entries=np.array([f"e{i}" for i in range(n)], dtype=object),
        populations=np.array(["pop1"] * n, dtype=object),
        loci_alleles=np.array([f"chr1\t{j+1}\tA|T\tA" for j in range(p)], dtype=object),
        allele_frequencies=F,
    )
    b = rng.normal(size=p) * (rng.random(p) < 0.01)
    y = F @ b + 0.5 * rng.normal(size=n)
    np.testing.assert_array_equal(out["y"], y)
    gj.write_bed(genomes, tmp_path / "panel")
    gebv, _ = gj.gblup_from_bed(tmp_path / "panel", y, lam=lam, block_cols=block_cols)
    gebv = np.asarray(gebv, np.float64)
    assert np.abs(out["gebv"] - gebv).max() <= 1e-4 * np.abs(gebv).max()
    assert abs(out["cor"] - _cor(gebv, y)) <= 1e-4


def test_multichip_sharding_matches_jax_grm(tmp_path):
    out, stdout = _run_example("torch_multichip_sharding", tmp_path, n=64, l=200, ranks=2,
                               n_iter=60, n_burnin=20)
    assert "2 ranks: cpu" in stdout and "sharded GRM: (64, 64)" in stdout
    assert out["ranks_equal"] and "every rank returned the same bits: True" in stdout
    X, D = out["X"], out["dosages"]
    # Held on the raw Gram's scale: a centered Gram of a ~0.5-mean panel
    # cancels raw entries several times its size (see test_torch_grm.py).
    for K, ref, raw in ((out["K"], grm_jax.gram_panel(X), X.astype(np.float64) @ X.T),
                        (out["K_dosage"], grm_jax.gram_dosage(D, ploidy=2),
                         D.astype(np.float64) @ D.T / 4.0)):
        assert np.abs(K - np.asarray(ref)).max() <= 1e-5 * np.abs(raw).max()
    assert out["beta"].shape == (200,) and np.all(np.isfinite(out["beta"]))
    assert np.all(np.isfinite(out["b_hat"])) and np.isfinite(out["fit_cor"])


def test_make_big_bed_matches_jax_script(tmp_path, capsys):
    code = textwrap.dedent(f"""
        import runpy, sys
        sys.modules["jax"] = None
        sys.argv = ["torch_make_big_bed.py", {str(tmp_path / "port")!r}, "37", "101"]
        runpy.run_path({str(ROOT / "scripts" / "torch_make_big_bed.py")!r}, run_name="__main__")
    """) + _NO_JAX
    port_line = _child(code, tmp_path).stdout.strip().splitlines()[-1]
    argv = sys.argv
    sys.argv = ["make_big_bed.py", str(tmp_path / "jax"), "37", "101"]
    try:
        runpy.run_path(str(ROOT / "scripts" / "make_big_bed.py"), run_name="__main__")
    finally:
        sys.argv = argv
    jax_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert port_line == jax_line.replace(str(tmp_path / "jax"), str(tmp_path / "port"))
    for ext in (".bed", ".bim", ".fam"):
        assert (tmp_path / f"port{ext}").read_bytes() == (tmp_path / f"jax{ext}").read_bytes(), ext


def _load_example(name: str):
    return runpy.run_path(str(ROOT / "examples" / f"{name}.py"), run_name=name)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_cuda_without_cuda_raises(name):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: device='cuda' is valid here")
    main = _load_example(name)["main"]
    with pytest.raises(RuntimeError, match="CUDA"):
        main(device="cuda")


def test_examples_default_to_cuda_on_the_command_line(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the examples would run on it")
    code = textwrap.dedent(f"""
        import runpy, sys
        sys.modules["jax"] = None
        for name in {EXAMPLES!r}:
            sys.argv = [name + ".py"]
            try:
                runpy.run_path({str(ROOT / "examples")!r} + "/" + name + ".py", run_name="__main__")
            except RuntimeError as err:
                assert "CUDA" in str(err), err
                print("raised", name)
            else:
                raise AssertionError(name + " ran without a card")
    """) + _NO_JAX
    assert _child(code, tmp_path).stdout.count("raised") == len(EXAMPLES)
