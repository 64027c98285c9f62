"""The port's CV harness (cv/harness.py), CVCheckpoint/job_signature,
tabularise/summarise and StageTimer held against the JAX package's on the
sim_small and sim_multipop fixtures: bit-identical job lists, notes and fold
composition, models run through cvbulk and the population modes, resume from
a ledger, n_workers=2 against n_workers=1, and the port's CV path with jax
unimportable."""

import subprocess
import sys
import textwrap
import threading
import warnings

import numpy as np
import pytest
import torch

import genomicbreedingmodels_tpu as gj
import genomicbreedingmodels_tpu_torch as gt
from genomicbreedingmodels_tpu.cv import harness as harness_jax
from genomicbreedingmodels_tpu.utils import checkpoint as ckpt_jax
from genomicbreedingmodels_tpu_torch import convert
from genomicbreedingmodels_tpu_torch.cv import harness
from genomicbreedingmodels_tpu_torch.utils import checkpoint, config
from genomicbreedingmodels_tpu_torch.utils.logging import StageTimer, torch_profile

torch.set_num_threads(2)
CPU = "cpu"


def _port(genomes, phenomes):
    return convert.genomes_from_reference(genomes), convert.phenomes_from_reference(phenomes)


def _with_missing(phenomes):
    """A copy with NaN phenotypes: every other entry of the first 30 for trait
    0, so cvbulk's skip rules and notes come into play at 2 folds of 1 rep."""
    ph = gj.clone(phenomes)
    ph.phenotypes[:30:2, 0] = np.nan
    return ph


def _capture_jax_jobs(monkeypatch):
    jobs_seen = []

    def fake(jobs, genomes, phenomes, **kw):
        jobs_seen.append(jobs)
        return []

    monkeypatch.setattr(harness_jax, "cvdispatch", fake)
    return jobs_seen


def _same_jobs(jt, jj):
    assert len(jt) == len(jj)
    for a, b in zip(jt, jj):
        assert set(a) == set(b)
        for k in a:
            if k in ("idx_training", "idx_validation"):
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
            else:
                assert a[k] == b[k], k


@pytest.mark.parametrize("reps,folds,seed", [(2, 3, 42), (3, 10, 7)])
def test_cvbulk_jobs_and_notes_bit_identical(sim_small, monkeypatch, reps, folds, seed):
    """Same seed, same jobs: model, trait, the index sets of every fold, the
    replication and fold strings, and the notes of skipped folds."""
    genomes, phenomes, _ = sim_small
    ph = _with_missing(phenomes)
    seen = _capture_jax_jobs(monkeypatch)
    _, notes_j = gj.cvbulk(genomes, ph, models=["ridge", "ols"], n_replications=reps, n_folds=folds, seed=seed)
    g, p = _port(genomes, ph)
    jobs_t, notes_t = harness._cvbulk_jobs(g, p, ["ridge", "ols"], reps, folds, seed)
    _same_jobs(jobs_t, seen[0])
    assert notes_t == notes_j


def test_cvbulk_notes_on_skipped_folds(sim_small, monkeypatch):
    """Folds with too few finite entries are noted, identically."""
    genomes, phenomes, _ = sim_small
    ph = gj.clone(phenomes)
    ph.phenotypes[2:, 0] = np.nan  # two finite entries: every fold starves
    seen = _capture_jax_jobs(monkeypatch)
    _, notes_j = gj.cvbulk(genomes, ph, models=["ols"], n_replications=1, n_folds=2, seed=1)
    g, p = _port(genomes, ph)
    jobs_t, notes_t = harness._cvbulk_jobs(g, p, ["ols"], 1, 2, 1)
    _same_jobs(jobs_t, seen[0])
    assert notes_t == notes_j and len(notes_t) >= 1 and notes_t[0].startswith("too_many_missing;")


@pytest.mark.parametrize("mode", ["pairwise", "lopo"])
def test_population_jobs_bit_identical(sim_multipop, mode):
    genomes, phenomes, _ = sim_multipop
    ph = gj.clone(phenomes)
    ph.phenotypes[:50, 1] = np.nan  # one population loses trait 2: a note
    jobs_j, notes_j = harness_jax._population_pair_jobs(genomes, ph, ["ridge", "gblup"], mode)
    g, p = _port(genomes, ph)
    jobs_t, notes_t = harness._population_pair_jobs(g, p, ["ridge", "gblup"], mode)
    _same_jobs(jobs_t, jobs_j)
    assert notes_t == notes_j


def test_job_signature_bit_identical(sim_small):
    genomes, phenomes, _ = sim_small
    g, p = _port(genomes, phenomes)
    jobs, _ = harness._cvbulk_jobs(g, p, ["ridge", gt.ols], 1, 3, 5)
    sigs = [checkpoint.job_signature(j) for j in jobs]
    assert sigs == [ckpt_jax.job_signature(j) for j in jobs] and len(set(sigs)) == len(sigs)


def _cv_keys(cvs):
    return [(cv.fit.trait, cv.fit.model, cv.replication, cv.fold) for cv in cvs]


def test_cvbulk_matches_jax(sim_small):
    """ols and ridge through both packages' cvbulk, 1 × 3 folds: the same
    (trait, model, replication, fold) tags, validation entries and y_true;
    ridge y_pred within 1e-3·std(y); ols within 1e-2·std(y) (its float32
    interpolant, see test_torch_linalg.py). gblup's fit is held against the
    JAX one in test_torch_gblup.py, lasso's in test_torch_linear.py."""
    genomes, phenomes, _ = sim_small
    g, p = _port(genomes, phenomes)
    models = ["ols", "ridge"]
    cj, nj = gj.cvbulk(genomes, phenomes, models=models, n_replications=1, n_folds=3, seed=3)
    ct, nt = gt.cvbulk(g, p, models=models, n_replications=1, n_folds=3, seed=3, device=CPU)
    assert _cv_keys(ct) == _cv_keys(cj) and nt == nj and len(ct) == 6
    sd = phenomes.phenotypes[:, 0].std()
    for a, b in zip(ct, cj):
        assert a.checkdims() and np.array_equal(a.validation_entries, b.validation_entries)
        assert np.array_equal(a.validation_populations, b.validation_populations)
        assert np.array_equal(a.y_true, b.y_true)
        tol = 1e-2 if a.fit.model == "ols" else 1e-3
        assert np.abs(a.y_pred - b.y_pred).max() <= tol * sd, a.fit.model
        assert set(a.metrics) == set(b.metrics)


def test_population_modes_match_jax(sim_multipop):
    """cvperpopulation, cvpairwisepopulation and cvleaveonepopulationout with
    ridge: the same tags, training and validation entries; y_pred within
    1e-3·std(y) of each trait."""
    genomes, phenomes, _ = sim_multipop
    g, p = _port(genomes, phenomes)
    kw = dict(models=["ridge"], n_replications=1, n_folds=2, seed=1)
    for name in ("cvperpopulation", "cvpairwisepopulation", "cvleaveonepopulationout"):
        cj, nj = getattr(gj, name)(genomes, phenomes, **kw)
        ct, nt = getattr(gt, name)(g, p, device=CPU, **kw)
        assert _cv_keys(ct) == _cv_keys(cj) and nt == nj and len(ct) > 0, name
        for a, b in zip(ct, cj):
            assert np.array_equal(a.fit.entries, b.fit.entries)
            assert np.array_equal(a.validation_entries, b.validation_entries)
            sd = np.nanstd(phenomes.phenotypes[:, phenomes.trait_index(a.fit.trait)])
            assert np.abs(a.y_pred - b.y_pred).max() <= 1e-3 * sd, name


def test_validate_and_leakage(sim_small):
    genomes, phenomes, _ = sim_small
    g, p = _port(genomes, phenomes)
    fit = gt.ridge(g, p, idx_entries=np.arange(80), n_lambda=5, n_folds=3, device=CPU)
    cv = gt.validate(fit, g, p, idx_validation=np.arange(80, 100), replication="r", fold="f", device=CPU)
    assert cv.checkdims() and len(cv.y_pred) == 20 and (cv.replication, cv.fold) == ("r", "f")
    assert np.allclose(cv.y_pred, gt.predict(fit, g, np.arange(80, 100), device=CPU))
    with pytest.raises(ValueError, match="data leakage"):
        gt.validate(fit, g, p, idx_validation=np.arange(70, 90), device=CPU)


def test_cvdispatch_warns_and_continues(sim_small):
    """A model that raises is warned about and dropped (the reference's
    warn-and-continue); the other jobs' results keep their order."""
    genomes, phenomes, _ = sim_small
    g, p = _port(genomes, phenomes)

    def broken(**kw):
        raise RuntimeError("boom")

    jobs, _ = harness._cvbulk_jobs(g, p, ["ols", broken], 1, 2, 0)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        cvs = gt.cvdispatch(jobs, g, p, device=CPU)
    assert len(cvs) == 2 and all(cv.fit.model == "ols" for cv in cvs)
    msgs = [str(w.message) for w in rec if "unexpected model-fitting error" in str(w.message)]
    assert len(msgs) == 2 and "'broken'" in msgs[0] and "boom" in msgs[0]
    with pytest.raises(ValueError, match="not a valid genomic prediction model"):
        gt.cvbulk(g, p, models=["nope"], device=CPU)
    with pytest.raises(ValueError, match="n_folds"):
        gt.cvbulk(g, p, n_folds=0, device=CPU)


def test_checkpoint_resumes(sim_small, tmp_path, monkeypatch):
    """A ledger written by one sweep serves the next: with every model
    broken, the second run still returns the first run's CVs."""
    genomes, phenomes, _ = sim_small
    g, p = _port(genomes, phenomes)
    jobs, _ = harness._cvbulk_jobs(g, p, ["ridge"], 1, 3, 0)
    path = str(tmp_path / "cv.ledger")
    first = gt.cvdispatch(jobs, g, p, checkpoint_path=path, device=CPU)
    assert len(checkpoint.CVCheckpoint(path)) == 3

    def fail(*a, **k):
        raise AssertionError("a checkpointed job ran again")

    monkeypatch.setattr(harness, "_run_job", fail)
    again = gt.cvdispatch(jobs, g, p, checkpoint_path=path, device=CPU, n_workers=2)
    assert [cv.y_pred.tolist() for cv in again] == [cv.y_pred.tolist() for cv in first]


def test_two_workers_equal_one(sim_small):
    """n_workers=2 against n_workers=1 on the CPU: identical CVs in the same
    order, for ridge and a short BayesC chain (K3's plain version)."""
    genomes, phenomes, _ = sim_small
    g, p = _port(genomes, phenomes)
    cfg = config.get_config()
    config.set_config(config.GBMConfig(mcmc_n_iter=30, mcmc_n_burnin=10))
    try:
        runs = [gt.cvbulk(g, p, models=["ridge", "bayesc"], n_replications=1, n_folds=2, seed=4,
                          n_workers=w, device=CPU)[0] for w in (1, 2)]
    finally:
        config.set_config(cfg)
    assert _cv_keys(runs[0]) == _cv_keys(runs[1]) and len(runs[0]) == 4
    for a, b in zip(*runs):
        assert np.array_equal(a.y_pred, b.y_pred)


def test_cvdispatch_round_robin_devices(sim_small):
    """Job i runs on devices[i % D]: two CPU device names, results as one."""
    genomes, phenomes, _ = sim_small
    g, p = _port(genomes, phenomes)
    jobs, _ = harness._cvbulk_jobs(g, p, ["ridge"], 1, 2, 0)
    a = gt.cvdispatch(jobs, g, p, devices=["cpu", torch.device("cpu")], n_workers=2)
    b = gt.cvdispatch(jobs, g, p, device=CPU)
    assert [cv.y_pred.tolist() for cv in a] == [cv.y_pred.tolist() for cv in b]


def test_tabularise_and_summarise_of_converted_jax_cvs(sim_multipop):
    """JAX CVs carried across by convert.cv_from_reference: the port's
    frames equal the JAX package's, column for column."""
    pd = pytest.importorskip("pandas")
    genomes, phenomes, _ = sim_multipop
    cj, _ = gj.cvbulk(genomes, phenomes, models=["ridge"], n_replications=1, n_folds=2, seed=1)
    ct = [convert.cv_from_reference(cv) for cv in cj]
    assert all(cv.checkdims() for cv in ct)
    for mine, ref in zip(gt.tabularise(ct) + gt.summarise(ct), gj.tabularise(cj) + gj.summarise(cj)):
        pd.testing.assert_frame_equal(mine, ref)
    empty = gt.summarise([])
    assert len(empty[0]) == 0 and len(empty[1]) == 0


def test_stage_timer_threads_and_profile(tmp_path):
    """StageTimer loses no update from 8 threads; torch_profile writes its
    trace."""
    timer = StageTimer()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(200):
                with timer.stage("s"):
                    pass

        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert timer.counts["s"] == 1600 and timer.summary()["s"]["count"] == 1600
    with torch_profile(str(tmp_path / "prof")) as prof:
        torch.ones(8) @ torch.ones(8)
    assert (tmp_path / "prof" / "trace.json").is_file() and prof is not None


def test_port_cv_path_runs_without_jax(tmp_path):
    """In a fresh interpreter where `import jax` fails, the port imports
    (without pandas too) and runs cvbulk, gwasols and gblup_multitrait_cov
    on a tiny panel on the CPU, then the mesh layer (`parallel/`: the sharded
    GRM and gwasols over two thread ranks) and the quick parity ledger."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import numpy as np
        import genomicbreedingmodels_tpu_torch as gt
        assert "pandas" not in sys.modules
        g = gt.simulate_genomes(n=30, l=60, seed=1)
        trials, _ = gt.simulate_trials(g, f_add_dom_epi=np.array([[0.4, 0.05, 0.05]]), seed=1)
        p = gt.extract_phenomes(trials)
        cvs, notes = gt.cvbulk(g, p, models=["ols", "ridge"], n_replications=1, n_folds=2, device="cpu")
        assert len(cvs) == 4, len(cvs)
        assert np.all(np.isfinite(gt.gwasols(g, p, device="cpu").b_hat))
        trials2, _ = gt.simulate_trials(g, f_add_dom_epi=np.array([[0.4, 0.0, 0.0], [0.2, 0.0, 0.0]]), seed=2)
        fits = gt.gblup_multitrait_cov(g, gt.extract_phenomes(trials2), device="cpu")
        assert len(fits) == 2 and all(np.all(np.isfinite(f.y_pred)) for f in fits)
        # The mesh layer and the parity ledger import and run without jax too.
        from genomicbreedingmodels_tpu_torch.parallel import distributed, sharded
        from genomicbreedingmodels_tpu_torch.parallel.mesh import run_ranks
        from genomicbreedingmodels_tpu_torch.parity import run_parity_ledger
        assert distributed.process_local_panel_slice(60) == (0, 60)
        Ks = run_ranks(lambda m: sharded.sharded_grm(g.allele_frequencies, m), shape=(1, 2), device="cpu")
        assert Ks[0].shape == (30, 30) and bool((Ks[0] == Ks[1]).all())
        zs = run_ranks(lambda m: gt.gwasols(g, p, mesh=m).b_hat, shape=(1, 2), device="cpu")
        assert np.array_equal(zs[0], zs[1]) and np.all(np.isfinite(zs[0]))
        assert all(r["pass"] for r in run_parity_ledger(emit=lambda s: None, quick=True, device="cpu"))
        loaded = [m for m, mod in sys.modules.items() if mod is not None]
        assert not any(m.startswith(("jax", "genomicbreedingmodels_tpu.")) or m == "genomicbreedingmodels_tpu"
                       for m in loaded), "jax or the JAX package was imported"
        print("ok", len(cvs))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         cwd=str(tmp_path), env={"PYTHONPATH": str(_repo_root()), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok 4")


def _repo_root():
    from pathlib import Path

    return Path(gt.__file__).resolve().parents[1]
