"""The port's command line (`python -m genomicbreedingmodels_tpu_torch`) and
plots held against the JAX package's on the same files, on the CPU
(`--device cpu`): fit → predict round trips, a JAX-CLI `.npz` predicted by
the port's CLI (and the reverse) within CLI_TOL·max|GEBV| of the JAX CLI,
`cv` and `gwas` tables, `grm` in memory and `--streaming` against each other
and against the JAX CLI (CLI_TOL·max|K|), `manhattan_data` against JAX's
(values within 1e-6), the PNGs, and the whole out-of-core path with jax
unimportable."""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import genomicbreedingmodels_tpu as gj
import genomicbreedingmodels_tpu_torch as gt
from genomicbreedingmodels_tpu.__main__ import main as main_jax
from genomicbreedingmodels_tpu_torch import convert
from genomicbreedingmodels_tpu_torch.__main__ import main

torch.set_num_threads(2)
CLI_TOL = 1e-5
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """tests/test_cli.py's files: 60 x 150 called dosages as .bed and TSV, one trait."""
    d = tmp_path_factory.mktemp("cli")
    genomes = gj.simulate_genomes(n=60, l=150, seed=9)
    genomes.allele_frequencies = np.round(genomes.allele_frequencies * 2) / 2
    trials, _ = gj.simulate_trials(genomes, f_add_dom_epi=np.array([[0.5, 0.0, 0.0]]), seed=9)
    gj.write_bed(genomes, d / "panel")
    gj.write_genomes_tsv(genomes, d / "panel.tsv")
    gj.write_phenomes_tsv(gj.extract_phenomes(trials), d / "pheno.tsv")
    return d


def _gebv(path):
    rows = Path(path).read_text().strip().splitlines()
    assert rows[0] == "entry\tpopulation\tgebv"
    return np.array([float(r.split("\t")[2]) for r in rows[1:]])


def test_cli_fit_and_predict_roundtrip(data_dir, capsys):
    fitp = data_dir / "fit.npz"
    assert main(["fit", "--geno", str(data_dir / "panel.bed"), "--pheno", str(data_dir / "pheno.tsv"),
                 "--model", "ridge", "--out", str(fitp), "--device", "cpu"]) == 0
    info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert info["model"] == "ridge" and info["cor"] > 0.5
    outp = data_dir / "gebv.tsv"
    assert main(["predict", "--geno", str(data_dir / "panel.bed"), "--fit", str(fitp),
                 "--out", str(outp), "--device", "cpu"]) == 0
    vals = _gebv(outp)
    assert len(vals) == 60 and np.isfinite(vals).all()


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("model", ["ridge", "gblup"])
def test_cli_npz_crosses_packages(data_dir, writer, model):
    """A `.npz` from either CLI's `fit` is predicted by the port's CLI within
    CLI_TOL·max|GEBV| of the JAX CLI's `predict` of the same file."""
    geno, pheno = str(data_dir / "panel.bed"), str(data_dir / "pheno.tsv")
    fitp = data_dir / f"{writer}_{model}.npz"
    if writer == "jax":
        assert main_jax(["fit", "--geno", geno, "--pheno", pheno, "--model", model, "--out", str(fitp)]) == 0
    else:
        assert main(["fit", "--geno", geno, "--pheno", pheno, "--model", model, "--out", str(fitp),
                     "--device", "cpu"]) == 0
    assert main(["predict", "--geno", geno, "--fit", str(fitp), "--out", str(data_dir / "t.tsv"),
                 "--device", "cpu"]) == 0
    assert main_jax(["predict", "--geno", geno, "--fit", str(fitp), "--out", str(data_dir / "j.tsv")]) == 0
    got, ref = _gebv(data_dir / "t.tsv"), _gebv(data_dir / "j.tsv")
    assert float(np.abs(got - ref).max()) <= CLI_TOL * float(np.abs(ref).max())


def test_cli_cv_writes_tables(data_dir, capsys):
    out = data_dir / "cvout"
    assert main(["cv", "--geno", str(data_dir / "panel.tsv"), "--pheno", str(data_dir / "pheno.tsv"),
                 "--models", "ridge,ols", "--replications", "1", "--folds", "2",
                 "--out", str(out), "--device", "cpu"]) == 0
    for f in ("cv_across.tsv", "cv_per_entry.tsv", "cv_summary.tsv", "cv_summary_per_entry.tsv",
              "notes.txt"):
        assert (out / f).exists()
    import pandas as pd

    across = pd.read_csv(out / "cv_across.tsv", sep="\t")
    assert "cor" in across.columns and set(across["model"]) == {"ridge", "ols"} and len(across) == 4  # 2 models x 2 folds


def test_cli_gwas_writes_hits_as_jax(data_dir):
    """The hits table: JAX's columns, loci and order, statistics within 1e-4
    of the JAX CLI's (the scans are held tighter in test_torch_gwas.py)."""
    import pandas as pd

    args = ["gwas", "--geno", str(data_dir / "panel.bed"), "--pheno", str(data_dir / "pheno.tsv"),
            "--method", "ols"]
    assert main(args + ["--out", str(data_dir / "hits.tsv"), "--plot", str(data_dir / "man.png"),
                        "--device", "cpu"]) == 0
    assert main_jax(args + ["--out", str(data_dir / "hits_jax.tsv")]) == 0
    got = pd.read_csv(data_dir / "hits.tsv", sep="\t")
    ref = pd.read_csv(data_dir / "hits_jax.tsv", sep="\t")
    assert list(got.columns) == ["locus", "chrom", "pos", "stat", "neg_log10_p"] == list(ref.columns)
    assert len(got) == len(ref) > 100 and list(got["locus"]) == list(ref["locus"])
    np.testing.assert_allclose(got["stat"], ref["stat"], atol=1e-4 * float(ref["stat"].abs().max()))
    assert (data_dir / "man.png").stat().st_size > 1000


@pytest.mark.parametrize("block_cols", [64, 150])
def test_cli_grm_streaming_matches_in_memory_and_jax(data_dir, block_cols):
    """In memory (VanRaden-scaled) and `--streaming` (raw centered) agree up
    to that scale, and each matches the JAX CLI's own output file."""
    geno = str(data_dir / "panel.bed")
    out = {}
    for name, extra in (("mem", []), ("stream", ["--streaming", "--block-cols", str(block_cols)])):
        assert main(["grm", "--geno", geno, "--out", str(data_dir / f"t_{name}.npy"),
                     "--device", "cpu"] + extra) == 0
        assert main_jax(["grm", "--geno", geno, "--out", str(data_dir / f"j_{name}.npy")] + extra) == 0
        out[name] = np.load(data_dir / f"t_{name}.npy"), np.load(data_dir / f"j_{name}.npy")
        got, ref = out[name]
        assert got.shape == (60, 60) and got.dtype == np.float32
        assert float(np.abs(got - ref).max()) <= CLI_TOL * float(np.abs(ref).max())
    Km, Ks = out["mem"][0], out["stream"][0]
    s = np.trace(Km) / np.trace(Ks)
    assert float(np.abs(Km - Ks * s).max()) <= CLI_TOL * float(np.abs(Km).max())


def test_cli_grm_tsv_output(data_dir):
    assert main(["grm", "--geno", str(data_dir / "panel.tsv"), "--out", str(data_dir / "k.tsv"),
                 "--grm-type", "ploidy-aware", "--device", "cpu"]) == 0
    K = np.loadtxt(data_dir / "k.tsv", delimiter="\t")
    assert K.shape == (60, 60) and np.allclose(K, K.T, atol=1e-6)


def test_cli_unknown_model_errors(data_dir):
    with pytest.raises(ValueError):
        main(["fit", "--geno", str(data_dir / "panel.tsv"), "--pheno", str(data_dir / "pheno.tsv"),
              "--model", "nope", "--out", str(data_dir / "x.npz"), "--device", "cpu"])


def test_cli_cuda_without_card_raises(data_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["grm", "--geno", str(data_dir / "panel.bed"), "--out", str(data_dir / "g.npy")])


def _gwas_fit():
    """One GWAS-shaped JAX Fit (statistics of both signs, several
    chromosomes, a label without coordinates) and its port copy."""
    rng = np.random.default_rng(2)
    p = 40
    labels = [f"chrom_{1 + j % 3}\t{1000 - 7 * j}\tA|T\tA" for j in range(p - 1)] + ["plain_id"]
    fj = gj.Fit(model="gwasols", b_hat=rng.normal(size=p) * 4, b_hat_labels=np.array(labels, dtype=object),
                trait="t", entries=np.array([f"e{i}" for i in range(25)], dtype=object),
                populations=np.array(["p"] * 25, dtype=object), y_true=np.zeros(25), y_pred=np.zeros(25),
                metrics={})
    return fj, convert.fit_from_reference(fj)


@pytest.mark.parametrize("dist", ["normal", "t"])
def test_manhattan_data_matches_jax(dist):
    fj, ft = _gwas_fit()
    ref = gj.manhattan_data(fj, dist=dist)
    got = gt.manhattan_data(ft, dist=dist)
    assert list(got.columns) == list(ref.columns)
    for col in ("locus", "chrom", "pos"):
        assert list(got[col]) == list(ref[col])
    np.testing.assert_allclose(got["stat"], ref["stat"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["neg_log10_p"], ref["neg_log10_p"], rtol=0, atol=1e-6)
    with pytest.raises(ValueError):
        gt.manhattan_data(ft, dist="chi2")


def test_plots_write_pngs(tmp_path, sim_small):
    genomes, phenomes, _ = sim_small
    g, p = convert.genomes_from_reference(genomes), convert.phenomes_from_reference(phenomes)
    fit = gt.gwasols(g, p, device="cpu")
    df = gt.plot_manhattan(fit, dist="t", save_path=str(tmp_path / "man.png"))
    assert len(df) == len(fit.b_hat) and np.isfinite(df["neg_log10_p"]).all()
    assert (tmp_path / "man.png").stat().st_size > 1000
    cvs, _ = gt.cvbulk(g, p, models=["ridge"], n_replications=1, n_folds=2, seed=42, device="cpu")
    df = gt.plot_cv(cvs, save_path=str(tmp_path / "cv.png"))
    assert len(df) == 2 and (tmp_path / "cv.png").stat().st_size > 1000


def test_out_of_core_and_cli_without_jax(tmp_path):
    """The new paths (codecs, streamer, grm_from_bed, the pieces CG, the CLI's
    fit/predict/grm, manhattan_data) with jax unimportable: neither jax nor
    the JAX package is imported, and pandas only by manhattan_data."""
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        from pathlib import Path
        import numpy as np
        import genomicbreedingmodels_tpu_torch as gt
        from genomicbreedingmodels_tpu_torch.__main__ import main
        from genomicbreedingmodels_tpu_torch.streaming import gblup_from_bed_pieces
        d = Path({str(tmp_path)!r})
        g = gt.simulate_genomes(n=40, l=90, seed=1)
        g.allele_frequencies = np.round(g.allele_frequencies * 2) / 2
        tr, _ = gt.simulate_trials(g, f_add_dom_epi=np.array([[0.5, 0.0, 0.0]]), seed=1)
        ph = gt.extract_phenomes(tr)
        gt.write_bed(g, d / "panel")
        gt.write_phenomes_tsv(ph, d / "pheno.tsv")
        back = gt.read_bed(d / "panel")
        assert np.array_equal(back.allele_frequencies, g.allele_frequencies)
        K = gt.grm_from_bed(d / "panel", block_cols=32, device="cpu")
        gebv, resid = gblup_from_bed_pieces(d / "panel", ph.phenotypes[:, 0], block_cols=32,
                                            block_rows=16, cg_iters=100, device="cpu")
        assert K.shape == (40, 40) and np.isfinite(gebv).all() and resid < 1e-3
        for args in (["fit", "--geno", str(d / "panel.bed"), "--pheno", str(d / "pheno.tsv"),
                      "--out", str(d / "f.npz")],
                     ["predict", "--geno", str(d / "panel.bed"), "--fit", str(d / "f.npz"),
                      "--out", str(d / "gebv.tsv")],
                     ["grm", "--geno", str(d / "panel.bed"), "--streaming", "--out", str(d / "k.npy")]):
            assert main(args + ["--device", "cpu"]) == 0
        assert "pandas" not in sys.modules
        fit = gt.gwasols(back, ph, device="cpu")
        assert len(gt.manhattan_data(fit)) == len(fit.b_hat) > 50
        loaded = [m for m, mod in sys.modules.items() if mod is not None]
        assert not any(m.startswith("jax") or m == "genomicbreedingmodels_tpu"
                       or m.startswith("genomicbreedingmodels_tpu.") for m in loaded), \\
            "jax or the JAX package was imported"
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         cwd=str(tmp_path), env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")
