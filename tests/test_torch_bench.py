"""The port's bench (bench_torch.py) on the CPU, at its `--device cpu` sizes
(bench.py's CPU sizes).

Each section's data come from its `<section>_inputs`; its result is held
against the JAX package on the same arrays: the headline's GEBVs within
1e-5·max|GEBV| of JAX `gram_dosage_lower` -> `gblup_solve_lower` at
λ = 0.1·p (its bf16 variant, of JAX `gram_panel` solved in float64); the three GWAS scans' statistics at cor >= 0.999 with the same
argmax; the CV jobs' tags and folds, ridge and gblup per fold within
1e-3·std(y); the epistasis features' names outside ties within 1e-5 of the
k-th |slope|; northstar's GEBVs within the CG residual + 1e-4·max|GEBV| of
JAX `ops/pieces.py` on the same shards; the sampler's lines finite and its
ESS-panel GEBVs at cor >= 0.95 with the JAX chain's. The frame: every
stdout line is the four-key JSON and the last is the headline's, also after
a section fails or runs out of time (the subprocess launcher replaced); the
sentinel line when the headline fails; no CUDA and no `--device cpu` exits
non-zero; a section that fails a check, or launches no kernel it should,
withholds its lines; `--parity --device cpu --quick` passes. The README's
port bench block parses and has one row per metric of the recorded run.
"""

import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genomicbreedingmodels_tpu as gj
from genomicbreedingmodels_tpu.features.endofunctions import mult as mult_jax
from genomicbreedingmodels_tpu.features.transform import transform2 as transform2_jax
from genomicbreedingmodels_tpu.models.bayesian import gibbs_regression as gibbs_jax
from genomicbreedingmodels_tpu.ops import pieces as pieces_jax
from genomicbreedingmodels_tpu.ops.chol import gblup_solve_lower as solve_jax
from genomicbreedingmodels_tpu.ops.grm import gram_dosage_lower as gram_lower_jax
from genomicbreedingmodels_tpu.ops.grm import gram_panel as gram_panel_jax

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
torch.set_num_threads(2)


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


bt = _load(ROOT / "bench_torch.py", "bench_torch")


def _sizes(name):
    return bt.SIZES[name][CPU]


def _run(name):
    """(the section's result, its Run) at the CPU sizes."""
    run = bt.Run(CPU, _sizes(name))
    return bt.SECTIONS[name](run), run


def _lines_ok(lines):
    for ln in lines:
        d = json.loads(ln)
        assert set(d) == {"metric", "value", "unit", "vs_baseline"}, ln
        assert np.isfinite(d["value"]) and d["vs_baseline"] == 1.0, ln


def _jax_panel(freq, y):
    n, p = freq.shape
    g = gj.Genomes(entries=np.array([f"e{i:05d}" for i in range(n)]),
                   populations=np.array(["pop_1"] * n),
                   loci_alleles=np.array([f"chr1\t{i}\tA|T\tA" for i in range(p)]),
                   allele_frequencies=freq)
    ph = gj.Phenomes(entries=g.entries, populations=g.populations, traits=np.array(["t"]),
                     phenotypes=np.asarray(y).reshape(n, 1))
    return g, ph


# ---------------------------------------------------------------------------
# sections against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bf16", [False, True])
def test_headline_matches_jax(bf16, monkeypatch):
    """int8: JAX `gram_dosage_lower` -> `gblup_solve_lower`; bf16
    (GBM_BENCH_BF16=1): JAX `gram_panel` of the same bf16 panel, solved in
    float64 (bench.py:731-741's step)."""
    monkeypatch.setenv("GBM_BENCH_BF16", "1" if bf16 else "0")
    res, run = _run("headline")
    _lines_ok(run.lines)
    assert len(run.lines) == 1 and bt.HEADLINE_METRIC in run.lines[0]
    X, y = bt.headline_inputs(_sizes("headline"), CPU, bf16=bf16)
    lam = 0.1 * X.shape[1]
    if bf16:
        K = np.asarray(gram_panel_jax(jnp.asarray(X.float().numpy()).astype(jnp.bfloat16)), np.float64)
        yc = y.double().numpy() - y.double().mean().item()
        ref = yc - lam * np.linalg.solve(K + lam * np.eye(len(yc)), yc) + y.double().mean().item()
    else:
        ref = np.asarray(solve_jax(gram_lower_jax(jnp.asarray(X.numpy()), ploidy=2),
                                   jnp.asarray(y.numpy()), jnp.float32(lam)))
    gebv = res["gebv"].numpy()
    assert np.all(np.isfinite(gebv))
    assert np.abs(gebv - ref).max() <= 1e-5 * np.abs(ref).max()


def test_headline_split_gives_the_step():
    """The six stages, run in turn, give the step's GEBVs (their times are a
    card's; here any clock)."""
    from genomicbreedingmodels_tpu_torch.ops.chol import gblup_solve_lower
    from genomicbreedingmodels_tpu_torch.ops.grm import gram_dosage_lower

    D, y = bt.headline_inputs(dict(n=256, p=1024), CPU)
    lam = 0.1 * 1024
    _, gebv, stages = bt.headline_split(D, y, lam, lambda fn: 0.0)
    assert len(stages) == 6 and all(len(v) == 4 for v in stages.values())
    step = gblup_solve_lower(gram_dosage_lower(D, ploidy=2, device=CPU), y, lam)
    assert torch.equal(gebv, step)


def test_gwas_matches_jax():
    res, run = _run("gwas")
    _lines_ok(run.lines)
    assert len(run.lines) == 4
    g, ph = _jax_panel(*bt.gwas_inputs(_sizes("gwas")))
    for name in ("gwasols", "gwaslmm", "gwasreml"):
        ref = getattr(gj, name)(genomes=g, phenomes=ph).b_hat
        mine = res[name]
        assert np.corrcoef(mine, ref)[0, 1] >= 0.999, name
        assert np.argmax(np.abs(mine)) == np.argmax(np.abs(ref)), name


def test_cv_matches_jax():
    res, run = _run("cv")
    _lines_ok(run.lines)
    assert len(run.lines) == 2
    sz = _sizes("cv")
    freq, y = bt.cv_inputs(sz)
    g, ph = _jax_panel(freq, y)
    cj, _ = gj.cvbulk_batched(g, ph, models=bt.CV_MODELS, n_replications=sz["n_replications"],
                              n_folds=sz["n_folds"], store_effects=False)
    ct = res["cvs"]

    def keys(cvs):
        return [(cv.fit.trait, cv.fit.model, cv.replication, cv.fold) for cv in cvs]

    assert keys(ct) == keys(cj) and len(ct) == sz["n_replications"] * sz["n_folds"] * 3
    sd = np.std(y)
    for a, b in zip(ct, cj):
        assert np.array_equal(a.validation_entries, b.validation_entries)
        if a.fit.model in ("ridge", "gblup"):
            assert np.abs(a.y_pred - b.y_pred).max() <= 1e-3 * sd, a.fit.model


def _slopes(F, y):
    Tm, ym = F - F.mean(0), y - y.mean()
    return (Tm.T @ ym) / np.maximum((Tm * Tm).sum(0), 1e-30)


def test_epistasis_matches_jax():
    res, run = _run("epistasis")
    _lines_ok(run.lines)
    assert len(run.lines) == 2
    sz = _sizes("epistasis")
    freq, y = bt.epistasis_inputs(sz)
    g, ph = _jax_panel(freq, y)
    out_j = transform2_jax(mult_jax, g, ph, n_new_features_per_transformation=sz["k"])
    out_t = res["features"]
    st = dict(zip(out_t.loci_alleles, np.abs(_slopes(out_t.allele_frequencies, y))))
    sj = dict(zip(out_j.loci_alleles, np.abs(_slopes(out_j.allele_frequencies, y))))
    kth = min(sj.values())
    for name in set(st) ^ set(sj):
        s = st.get(name, sj.get(name))
        assert abs(s - kth) <= 1e-5 * kth, (name, s, kth)
    assert len(set(st) & set(sj)) >= 0.95 * len(sj)


def test_northstar_matches_jax():
    res, run = _run("northstar")
    _lines_ok(run.lines)
    sz = _sizes("northstar")
    shard, y = bt.northstar_inputs(sz, CPU)
    n = sz["n"]
    bounds = pieces_jax.make_bounds(n, 4096)
    pieces = pieces_jax.zero_pieces(n, bounds)
    for s in range(sz["n_shards"]):
        pieces = pieces_jax.accumulate_dosage_shard(pieces, jnp.asarray(shard(s).numpy()), bounds=bounds,
                                                    snp_major=False)
    pieces = pieces_jax.center_scale_pieces(pieces, jnp.float32(4.0), bounds=bounds)
    ref, _ = pieces_jax.cg_solve_pieces(pieces, jnp.asarray(y.numpy()), jnp.float32(1e-3), bounds=bounds,
                                        iters=30)
    ref = np.asarray(ref)
    assert np.abs(res["gebv"] - ref).max() <= res["resid"] + 1e-4 * np.abs(ref).max()


def test_sampler_matches_jax():
    res, run = _run("sampler")
    _lines_ok(run.lines)
    assert len(run.lines) == 4
    sz = _sizes("sampler")
    inp = bt.sampler_inputs(sz)
    for model in ("BayesC", "BRR"):
        mu, b, _ = gibbs_jax(inp["X_e"], inp["y_e"], model=model, n_iter=sz["iter_e"],
                             n_burnin=sz["burn_e"], seed=2)
        ref = mu + inp["X_e"] @ np.asarray(b)
        assert np.corrcoef(res[model], ref)[0, 1] >= 0.95, model


@pytest.mark.parametrize("name", ["linkprobe", "samplerbig", "diskstream"])
def test_other_sections_run_and_check(name, tmp_path, monkeypatch):
    """The sections without a JAX comparison emit finite four-key lines and
    pass their own checks (diskstream writes its panel under tmp_path)."""
    monkeypatch.setattr(bt.tempfile, "tempdir", str(tmp_path))
    monkeypatch.delenv("GBM_BENCH_BED", raising=False)
    _, run = _run(name)
    _lines_ok(run.lines)
    assert len(run.lines) == {"linkprobe": 1, "samplerbig": 2, "diskstream": 1}[name]
    assert all(json.loads(ln)["metric"].endswith("[device=cpu]") for ln in run.lines)


# ---------------------------------------------------------------------------
# the frame
# ---------------------------------------------------------------------------


def test_main_headline_only_ends_with_the_headline(monkeypatch, capsys):
    monkeypatch.setenv("GBM_BENCH_HEADLINE_ONLY", "1")
    assert bt.main(CPU) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    _lines_ok(lines)
    assert len(lines) == 1 and json.loads(lines[-1])["metric"].startswith(bt.HEADLINE_METRIC)


def _fake_launcher(fail=(), timeout=(), headline_ok=True):
    """A stand-in for the section subprocess: a canned line per section;
    sections in `fail` exit 1 with no line, those in `timeout` run out of
    time after printing one line."""
    calls = []

    def launch(cmd, timeout_s):
        name = cmd[cmd.index("--section") + 1]
        calls.append((name, timeout_s))
        line = bt._line(f"{bt.HEADLINE_METRIC} (fake)" if name == "headline" else f"{name} metric",
                        1.0, "u")
        if name in fail or (name == "headline" and not headline_ok):
            return 1, "", f"# {name} check FAILED\nTraceback: not forwarded\n"
        if name in timeout:
            return None, line + "\n", "# partial\n"
        return 0, line + "\n", f"# {name} launches K1=0 K2=0 K3=0\n"

    return launch, calls


def test_main_keeps_the_headline_last_after_failures(monkeypatch, capsys):
    launch, calls = _fake_launcher(fail=("gwas",), timeout=("cv",))
    monkeypatch.setattr(bt, "_launch", launch)
    monkeypatch.delenv("GBM_BENCH_HEADLINE_ONLY", raising=False)
    monkeypatch.delenv("GBM_BENCH_DISK", raising=False)
    monkeypatch.delenv("GBM_BENCH_BUDGET", raising=False)
    assert bt.main(CPU) == 1
    cap = capsys.readouterr()
    lines = cap.out.strip().splitlines()
    _lines_ok(lines)
    assert [c[0] for c in calls] == list(bt.SECTIONS)
    assert all(t <= bt.SECTION_CAP for _, t in calls)
    metrics = [json.loads(ln)["metric"] for ln in lines]
    assert metrics[-1] == f"{bt.HEADLINE_METRIC} (fake)"
    assert "gwas metric" not in metrics and "cv metric" in metrics  # a timed-out section's line is salvaged
    assert "# bench section gwas failed: exit 1" in cap.err and "timed out" in cap.err
    assert "Traceback" not in cap.err


def test_main_prints_the_sentinel_when_the_headline_fails(monkeypatch, capsys):
    launch, _ = _fake_launcher(headline_ok=False)
    monkeypatch.setattr(bt, "_launch", launch)
    monkeypatch.setenv("GBM_BENCH_HEADLINE_ONLY", "1")
    assert bt.main(CPU) == 1
    lines = capsys.readouterr().out.strip().splitlines()
    _lines_ok(lines[:-1])
    last = json.loads(lines[-1])
    assert last["metric"].startswith(bt.HEADLINE_METRIC) and "FAILED" in last["metric"]
    assert last["value"] == 0.0


def test_budget_skips_sections_under_their_floor(monkeypatch, capsys):
    launch, calls = _fake_launcher()
    monkeypatch.setattr(bt, "_launch", launch)
    monkeypatch.delenv("GBM_BENCH_HEADLINE_ONLY", raising=False)
    monkeypatch.setenv("GBM_BENCH_DISK", "0")
    monkeypatch.setenv("GBM_BENCH_BUDGET", "1")
    assert bt.main(CPU) == 1
    assert [c[0] for c in calls] == ["headline"]
    cap = capsys.readouterr()
    assert "SKIPPED" in cap.err and "diskstream" not in cap.err
    assert json.loads(cap.out.strip().splitlines()[-1])["metric"] == f"{bt.HEADLINE_METRIC} (fake)"


@pytest.mark.parametrize("args", [[], ["--section", "headline"], ["--parity"]])
def test_no_cuda_and_no_device_cpu_exits_nonzero(args):
    assert not torch.cuda.is_available()
    r = subprocess.run([sys.executable, str(ROOT / "bench_torch.py"), *args], capture_output=True,
                       text=True, timeout=120, cwd=ROOT)
    assert r.returncode != 0 and r.stdout == "" and "cuda" in r.stderr.lower()


def _fake_section(launch_kernel=None, fail_check=False):
    def section(run):
        from genomicbreedingmodels_tpu_torch.kernels import _build

        if launch_kernel:
            _build.count_launch(launch_kernel)
        bt.check(not fail_check, "a made-up check")
        run.emit("fake metric", 1.0, "u")

    return section


@pytest.mark.parametrize("case", ["check fails", "no kernel", "kernel launched"])
def test_run_section_withholds_lines(case, monkeypatch, capsys):
    """On the card a section that fails a check, or launches none of its
    kernels, prints no line and exits non-zero (the card is simulated: the
    section runs no device code)."""
    from genomicbreedingmodels_tpu_torch.kernels import _build

    section = {"check fails": _fake_section("gram_tri_float", fail_check=True),
               "no kernel": _fake_section(),
               "kernel launched": _fake_section("gram_tri_float")}[case]
    monkeypatch.setitem(bt.SECTIONS, "gwas", section)
    monkeypatch.setattr(bt, "_card_note", lambda run: None)
    monkeypatch.setattr(_build, "load", lambda: None)
    rc = bt.run_section("gwas", "cuda")
    out = capsys.readouterr()
    if case == "kernel launched":
        assert rc == 0 and json.loads(out.out)["metric"] == "fake metric"
        assert "gwas launches K1=0 K2=1 K3=0" in out.err
    else:
        assert rc == 1 and out.out == ""
        assert ("check FAILED" if case == "check fails" else "launched no K2") in out.err


def test_parity_quick_passes_on_the_cpu(capsys):
    assert bt.cli(["--parity", "--device", "cpu", "--quick"]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert len(rows) == 5 and all(r["pass"] for r in rows)


# ---------------------------------------------------------------------------
# the README block
# ---------------------------------------------------------------------------


def test_readme_port_bench_block_matches_the_recorded_run():
    upd = _load(ROOT / "scripts" / "torch_update_readme_bench.py", "torch_update_readme_bench")
    card, metrics = upd.parse_run((ROOT / upd.RECORDED).read_text())
    assert card and metrics
    text = (ROOT / "README.md").read_text()
    m = re.search(r"<!-- torch-bench:begin -->(.*?)<!-- torch-bench:end -->", text, re.S)
    assert m, "README.md lost its torch-bench markers"
    rows = [ln for ln in m.group(1).splitlines() if ln.startswith("| ") and "**" in ln]
    assert len(rows) == len(metrics)
    assert m.group(1).strip() == upd.table(card, metrics).strip()
    assert all(card in row for row in rows) and "GSNP/s" not in m.group(1)
