"""The port's epistasis feature engine (features/endofunctions.py and
features/transform.py) held against the JAX package's on the sim_small
fixture and on small numpy-seeded panels.

Tolerances: the endofunctions on numpy arrays are the same float64 numpy
expressions, so exactly equal; on float32 tensors within 1e-6 of the float64
values. transform1/transform2 rank by float32 slopes in both packages (the
same formulas, sums in other orders), so selected feature names must be
equal except for features whose float64 |slope| lies within 1e-5 relative of
the k-th selected one (boundary ties); the values of a selected feature are
computed on the host in float64 from the same loci, so common names carry
columns within 1e-6 (in fact equal). reconstitutefeatures is float64 numpy
in both: 1e-12.
"""

import warnings

import numpy as np
import pytest
import torch

import genomicbreedingmodels_tpu as gj
import genomicbreedingmodels_tpu_torch as gt
from genomicbreedingmodels_tpu.features import endofunctions as endo_jax
from genomicbreedingmodels_tpu.features import transform as transform_jax
from genomicbreedingmodels_tpu_torch import convert
from genomicbreedingmodels_tpu_torch.features import endofunctions as endo
from genomicbreedingmodels_tpu_torch.features import transform

torch.set_num_threads(2)
CPU = "cpu"
BOUNDARY_REL = 1e-5
UNARY = ("square", "invoneplus", "log10epsdivlog10eps")
BINARY = ("mult", "addnorm", "raise_")


@pytest.fixture(scope="module")
def data(sim_small):
    genomes, phenomes, _ = sim_small
    return genomes, phenomes, convert.genomes_from_reference(genomes), \
        convert.phenomes_from_reference(phenomes)


def _panel(F, y):
    """Genomes/Phenomes of both packages on the frequency matrix F (n, l)."""
    n, l = F.shape
    kw = dict(entries=np.array([f"e{i}" for i in range(n)], dtype=object),
              populations=np.array(["p"] * n, dtype=object))
    loci = np.array([f"c\t{j + 1}\tA|T\tA" for j in range(l)], dtype=object)
    out = []
    for pkg in (gj, gt):
        g = pkg.Genomes(loci_alleles=loci, allele_frequencies=F, **kw)
        p = pkg.Phenomes(traits=np.array(["t"], dtype=object), phenotypes=y[:, None], **kw)
        out += [g, p]
    return out


def _slopes(G, y):
    T = G.allele_frequencies
    Tm, ym = T - T.mean(0), y - y.mean()
    return (Tm.T @ ym) / np.maximum((Tm * Tm).sum(0), 1e-30)


def _assert_same_features(out_t, out_j, y):
    """Equal names outside the boundary ties; equal columns on common names."""
    nt, nj = list(out_t.loci_alleles), list(out_j.loci_alleles)
    st = dict(zip(nt, np.abs(_slopes(out_t, y))))
    sj = dict(zip(nj, np.abs(_slopes(out_j, y))))
    kth = min(sj.values())
    for name in set(nt) ^ set(nj):
        s = st.get(name, sj.get(name))
        assert abs(s - kth) <= BOUNDARY_REL * kth, (name, s, kth)
    common = [nm for nm in nj if nm in st]
    assert len(common) >= 0.95 * len(nj)
    pos_t, pos_j = {nm: i for i, nm in enumerate(nt)}, {nm: i for i, nm in enumerate(nj)}
    it = [pos_t[nm] for nm in common]
    ij = [pos_j[nm] for nm in common]
    np.testing.assert_allclose(out_t.allele_frequencies[:, it], out_j.allele_frequencies[:, ij],
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", UNARY + BINARY)
def test_endofunction_numpy_exact_and_tensor(name):
    rng = np.random.default_rng(1)
    x, y = rng.uniform(size=500), rng.uniform(size=500)
    args = (x,) if name in UNARY else (x, y)
    ref = getattr(endo_jax, name)(*args)
    np.testing.assert_array_equal(getattr(endo, name)(*args), ref)
    out = getattr(endo, name)(*(torch.as_tensor(a, dtype=torch.float32) for a in args))
    assert isinstance(out, torch.Tensor)
    np.testing.assert_allclose(out.double().numpy(), ref, rtol=0, atol=1e-6)


def test_registry_names_cross_packages():
    assert set(endo.FUNCTION_REGISTRY) == set(endo_jax.FUNCTION_REGISTRY)
    for key, f in endo.FUNCTION_REGISTRY.items():
        assert endo.registry_name(f) == endo_jax.registry_name(endo_jax.FUNCTION_REGISTRY[key])
    assert [endo.registry_name(f) for f in endo.UNARY_DEFAULTS + endo.BINARY_DEFAULTS] == \
        [endo_jax.registry_name(f) for f in endo_jax.UNARY_DEFAULTS + endo_jax.BINARY_DEFAULTS]
    assert all(callable(getattr(gt, n)) for n in UNARY + BINARY + (
        "transform1", "transform2", "epistasisfeatures", "reconstitutefeatures",
        "parse_feature_name"))


@pytest.mark.parametrize("name", UNARY)
def test_transform1_matches_jax(data, name):
    genomes, phenomes, g, p = data
    kw = dict(n_new_features_per_transformation=150)
    out_j = gj.transform1(getattr(gj, name), genomes, phenomes, **kw)
    out_t = gt.transform1(getattr(gt, name), g, p, device=CPU, **kw)
    assert 0 < out_t.p <= 150 and out_t.checkdims()
    _assert_same_features(out_t, out_j, phenomes.phenotypes[:, 0])


@pytest.mark.parametrize("name,commutative", [("mult", False), ("addnorm", False),
                                              ("raise_", False), ("mult", True),
                                              ("addnorm", True)])
def test_transform2_matches_jax(data, name, commutative):
    genomes, phenomes, g, p = data
    kw = dict(n_new_features_per_transformation=200, commutative=commutative)
    if name == "raise_":  # the generic path materializes each block's pairs
        loci = np.arange(400)
        genomes, g = genomes.slice(idx_loci_alleles=loci), g.slice(idx_loci_alleles=loci)
    out_j = gj.transform2(getattr(gj, name), genomes, phenomes, **kw)
    out_t = gt.transform2(getattr(gt, name), g, p, device=CPU, **kw)
    assert out_t.p == out_j.p == 200
    _assert_same_features(out_t, out_j, phenomes.phenotypes[:, 0])
    if commutative:  # no pair below the diagonal
        tree = [transform.parse_feature_name(str(nm))[1] for nm in out_t.loci_alleles]
        ij = [tuple(g.locus_indices(t)) for t in tree]
        assert all(i <= j for i, j in ij)


@pytest.mark.parametrize("name", ["mult", "addnorm"])
def test_transform2_duplicated_columns_take_the_lower_index(name):
    """Three copies of one locus among noise: the pairs of a copy with
    another locus score exactly alike, and k cuts through such a tied run.
    lax.top_k keeps the lower (row, col), and so must the port: the same
    names as the JAX package, and the k best pairs by float64 |slope| with
    ties taken in (row, col) order."""
    rng = np.random.default_rng(4)
    n, l, k = 48, 20, 5
    F = rng.uniform(size=(n, l))
    F[:, 7] = F[:, 3]
    F[:, 12] = F[:, 3]
    y = 3.0 * F[:, 3] + 0.1 * rng.normal(size=n)
    gj_, pj_, gt_, pt_ = _panel(F, y)
    kw = dict(n_new_features_per_transformation=k, var_threshold=0.0)
    out_j = gj.transform2(getattr(gj, name), gj_, pj_, **kw)
    out_t = gt.transform2(getattr(gt, name), gt_, pt_, device=CPU, **kw)
    assert list(out_t.loci_alleles) == list(out_j.loci_alleles)
    np.testing.assert_array_equal(out_t.allele_frequencies, out_j.allele_frequencies)
    X, ym, fn = F + np.finfo(np.float64).eps, y - y.mean(), getattr(endo, name)
    ranked = []
    for a in range(l):
        for b in range(l):
            tm = fn(X[:, a], X[:, b])
            tm = tm - tm.mean()
            ranked.append((-round(abs(float(tm @ ym) / float(tm @ tm)), 9), a, b))
    ranked.sort()
    assert ranked[k - 1][0] == ranked[k][0]  # k cuts through a tie
    picked = {tuple(gt_.locus_indices(transform.parse_feature_name(str(nm))[1]))
              for nm in out_t.loci_alleles}
    assert picked == {(a, b) for _, a, b in ranked[:k]}


def test_topk_lower_index_rule():
    rng = np.random.default_rng(2)
    v = rng.integers(0, 4, size=(5, 300)).astype(np.float32) / 4  # many ties
    idx = transform._topk_lower(torch.from_numpy(v), 40).numpy()
    want = np.argsort(-v, axis=1, kind="stable")[:, :40]
    np.testing.assert_array_equal(idx, want)


def test_capacity_warning():
    """k beyond the running top-k's capacity rc·l_pad (128 · 256 at l = 200)
    warns in both packages, and both return the same top pairs."""
    rng = np.random.default_rng(5)
    n, l = 24, 200
    F = rng.uniform(size=(n, l))
    y = F[:, 0] * F[:, 1] + 0.1 * rng.normal(size=n)
    gj_, pj_, gt_, pt_ = _panel(F, y)
    kw = dict(n_new_features_per_transformation=l * l, var_threshold=0.0)
    with pytest.warns(RuntimeWarning, match="capacity 32768"):
        out_j = gj.transform2(gj.mult, gj_, pj_, **kw)
    with pytest.warns(RuntimeWarning, match="capacity 32768"):
        out_t = gt.transform2(gt.mult, gt_, pt_, device=CPU, **kw)
    assert out_t.p == out_j.p == 32768
    _assert_same_features(out_t, out_j, y)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # within capacity: no warning
        gt.transform2(gt.mult, gt_, pt_, device=CPU, n_new_features_per_transformation=100)


def test_parse_feature_name_matches_jax():
    for name in ("mult(a,b)", "raise(square(x),addnorm(y,invoneplus(z)))", "chr1\t5\tA|T\tA",
                 "log10epsdivlog10eps(mult(c\t1\tA|T\tA,c\t2\tA|T\tA))", "notafunc(a,b)"):
        assert gt.parse_feature_name(name) == transform_jax.parse_feature_name(name)


def test_epistasisfeatures_and_reconstitute_jax_names(data):
    """One round on a 300-locus slice in both packages: the same feature
    names outside boundary ties; the port reconstitutes the JAX package's
    names to the JAX package's matrix (1e-12), and its own round-trips."""
    genomes, phenomes, g, p = data
    loci = np.arange(300)
    genomes, g = genomes.slice(idx_loci_alleles=loci), g.slice(idx_loci_alleles=loci)
    kw = dict(n_new_features_per_transformation=40, n_reps=1)
    out_j = gj.epistasisfeatures(genomes, phenomes, **kw)
    out_t = gt.epistasisfeatures(g, p, device=CPU, **kw)
    assert out_t.p > g.p
    _assert_same_features(out_t.slice(idx_loci_alleles=np.arange(g.p, out_t.p)),
                          out_j.slice(idx_loci_alleles=np.arange(genomes.p, out_j.p)),
                          phenomes.phenotypes[:, 0])
    names = [str(nm) for nm in out_j.loci_alleles]
    rec_t = gt.reconstitutefeatures(g, names)
    rec_j = gj.reconstitutefeatures(genomes, names)
    np.testing.assert_allclose(rec_t.allele_frequencies, rec_j.allele_frequencies, rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(rec_t.allele_frequencies, out_j.allele_frequencies, rtol=0,
                               atol=1e-12)
    own = gt.reconstitutefeatures(g, [str(nm) for nm in out_t.loci_alleles])
    assert np.array_equal(own.allele_frequencies, out_t.allele_frequencies)


def test_mesh_raises_and_device_is_explicit(data):
    _, _, g, p = data
    # A mesh of one rank scans the pairs as mesh=None does.
    from genomicbreedingmodels_tpu_torch.parallel.mesh import run_ranks

    (one,) = run_ranks(lambda m: gt.transform2(gt.mult, g, p, mesh=m), shape=(1, 1), device=CPU)
    ref = gt.transform2(gt.mult, g, p, device=CPU)
    assert list(one.loci_alleles) == list(ref.loci_alleles)
    assert np.array_equal(one.allele_frequencies, ref.allele_frequencies)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            gt.transform2(gt.mult, g, p)


def test_epistasis_and_fold_chains_run_without_jax(tmp_path):
    """In a fresh interpreter where `import jax` fails, the port imports
    (without pandas) and runs transform2, epistasisfeatures,
    reconstitutefeatures and cvbulk_batched's bayesc on a tiny panel."""
    import subprocess
    import sys
    import textwrap
    from pathlib import Path

    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import numpy as np
        import genomicbreedingmodels_tpu_torch as gt
        assert "pandas" not in sys.modules
        g = gt.simulate_genomes(n=30, l=40, seed=1)
        trials, _ = gt.simulate_trials(g, f_add_dom_epi=np.array([[0.4, 0.05, 0.05]]), seed=1)
        p = gt.extract_phenomes(trials)
        out = gt.transform2(gt.mult, g, p, n_new_features_per_transformation=20, device="cpu")
        grown = gt.epistasisfeatures(g, p, n_new_features_per_transformation=5, n_reps=1, device="cpu")
        rec = gt.reconstitutefeatures(g, [str(nm) for nm in grown.loci_alleles])
        assert np.array_equal(rec.allele_frequencies, grown.allele_frequencies)
        cvs, _ = gt.cvbulk_batched(g, p, models=("bayesc",), n_replications=1, n_folds=2,
                                   mcmc_n_iter=20, mcmc_n_burnin=5, device="cpu")
        assert len(cvs) == 2 and all(np.all(np.isfinite(cv.y_pred)) for cv in cvs)
        loaded = [m for m, mod in sys.modules.items() if mod is not None]
        assert not any(m.startswith(("jax", "genomicbreedingmodels_tpu.")) or m == "genomicbreedingmodels_tpu"
                       for m in loaded), "jax or the JAX package was imported"
        print("ok", out.p)
    """)
    root = Path(gt.__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         cwd=str(tmp_path), env={"PYTHONPATH": str(root), "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == "ok 20"
