"""The port's GWAS suite (models/gwas.py) held against the JAX package on the
CPU: gwasprep, the device prep, PC1, gwasols, gwaslmm, gwasreml, and the
port's gwasreml against the f64 dense-pinv oracle of test_parity_oracles.

Fixture: the JAX package's `gwas_data` (tests/test_gwas.py), a
tetraploid-rounded 120x500 panel with one h²=0.5 trait of 5 QTL, made from
the same seeds and handed to the port through `convert`."""

import numpy as np
import pytest
import torch

import genomicbreedingmodels_tpu as gj
import genomicbreedingmodels_tpu_torch as gt
from genomicbreedingmodels_tpu.models import gwas as gwas_j
from genomicbreedingmodels_tpu_torch import convert
from genomicbreedingmodels_tpu_torch.models import gwas as gwas_t
from genomicbreedingmodels_tpu_torch.ops.linalg import _ramp

torch.set_num_threads(2)
CPU = "cpu"
GRM_TYPES = ["simple", "ploidy-aware"]


@pytest.fixture(scope="module")
def gwas_data():
    genomes = gj.simulate_genomes(n=120, l=500, seed=42)
    genomes.allele_frequencies = np.round(genomes.allele_frequencies * 4) / 4
    pv = np.zeros((9, 1))
    pv[0, 0] = 0.5
    trials, effects = gj.simulate_trials(
        genomes, f_add_dom_epi=np.array([[0.05, 0.0, 0.0]]),
        proportion_of_variance=pv, n_qtl=5, seed=42,
    )
    phenomes = gj.extract_phenomes(trials)
    port = convert.genomes_from_reference(genomes), convert.phenomes_from_reference(phenomes)
    return genomes, phenomes, port


@pytest.fixture(scope="module")
def gwas_scans(gwas_data):
    """Each scan run once by each package."""
    genomes, phenomes, (g, p) = gwas_data
    return {name: (getattr(gj, name)(genomes, phenomes), getattr(gt, name)(g, p, device=CPU))
            for name in ("gwasols", "gwaslmm", "gwasreml")}


def _with_constant_loci(genomes):
    """A copy whose first locus is constant and whose second differs in one
    entry by 1e-8 (sd ~1e-9): both packages must drop both."""
    X = genomes.allele_frequencies.copy()
    X[:, 0] = 0.5
    X[:, 1] = 0.25
    X[0, 1] += 1e-8
    return gj.Genomes(entries=genomes.entries, populations=genomes.populations,
                      loci_alleles=genomes.loci_alleles, allele_frequencies=X)


@pytest.mark.parametrize("grm_type", GRM_TYPES)
def test_gwasprep_matches(gwas_data, grm_type):
    """G and y to 1e-12, K to 1e-5·max|K| (the GRM is f32 in both), the same
    kept loci; K keeps the reference's asymmetry."""
    genomes, phenomes, _ = gwas_data
    genomes = _with_constant_loci(genomes)
    Gj, yj, Kj, fj = gj.gwasprep(genomes, phenomes, GRM_type=grm_type)
    Gt, yt, Kt, ft = gt.gwasprep(convert.genomes_from_reference(genomes),
                                 convert.phenomes_from_reference(phenomes),
                                 GRM_type=grm_type, device=CPU)
    assert np.array_equal(ft.b_hat_labels, fj.b_hat_labels)
    assert not set(genomes.loci_alleles[:2]) & set(ft.b_hat_labels)
    assert Gt.dtype == Kt.dtype == np.float64
    assert np.abs(Gt - Gj).max() <= 1e-12 and np.abs(yt - yj).max() <= 1e-12
    assert np.abs(Kt - Kj).max() <= 1e-5 * np.abs(Kj).max()
    assert np.abs(Kt - Kt.T).max() > 1e-6  # column-standardised: not symmetric


def _record_ploidy(module, monkeypatch):
    seen = []
    inner = module._prep_onchip

    def spy(Graw, y, ploidy):
        seen.append(float(ploidy))
        return inner(Graw, y, ploidy)

    monkeypatch.setattr(module, "_prep_onchip", spy)
    return seen


@pytest.mark.parametrize("grm_type", GRM_TYPES)
def test_prep_device_matches(gwas_data, grm_type, monkeypatch):
    """Gs and ys within 1e-5, Ks within 1e-4·max|Ks|, the same kept loci and
    the same ploidy (4 for the tetraploid panel under "ploidy-aware")."""
    genomes, phenomes, _ = gwas_data
    genomes = _with_constant_loci(genomes)
    pj, pt = _record_ploidy(gwas_j, monkeypatch), _record_ploidy(gwas_t, monkeypatch)
    gwas_j._PREP_CACHE.clear()
    gwas_t._PREP_CACHE.clear()
    Gj, yj, Kj, fj = gwas_j._prep_device(genomes, phenomes, GRM_type=grm_type)
    tm = {}
    Gt, yt, Kt, ft = gwas_t._prep_device(convert.genomes_from_reference(genomes),
                                         convert.phenomes_from_reference(phenomes),
                                         GRM_type=grm_type, timings=tm, device=CPU)
    assert np.array_equal(ft.b_hat_labels, fj.b_hat_labels)
    assert not set(genomes.loci_alleles[:2]) & set(ft.b_hat_labels)
    assert pt == pj == [4.0 if grm_type == "ploidy-aware" else 2.0]
    assert np.abs(Gt.numpy() - np.asarray(Gj)).max() <= 1e-5
    assert np.abs(yt.numpy() - np.asarray(yj)).max() <= 1e-5
    Kj = np.asarray(Kj)
    assert np.abs(Kt.numpy() - Kj).max() <= 1e-4 * np.abs(Kj).max()
    assert set(tm) == {"host_extract", "h2d+grm"}


def test_prep_device_cache(gwas_data):
    """The same panel, trait and device hits the cache (the same tensors);
    another trait index or GRM type misses."""
    _, _, (g, p) = gwas_data
    gwas_t._PREP_CACHE.clear()
    a = gwas_t._prep_device(g, p, device=CPU)
    b = gwas_t._prep_device(g, p, device=CPU)
    assert all(x is y for x, y in zip(a[:3], b[:3]))
    c = gwas_t._prep_device(g, p, GRM_type="ploidy-aware", device=CPU)
    assert c[2] is not a[2]


def test_pc1_matches_grm_pc1(gwas_data):
    """The power-iteration PC1 against the eigh one (|cos| >= 0.9999), and
    the port's numpy grm_pc1 equals the JAX package's."""
    genomes, phenomes, (g, p) = gwas_data
    _, _, K, _ = gj.gwasprep(genomes, phenomes)
    ref = gwas_j.grm_pc1(K)
    assert np.array_equal(gwas_t.grm_pc1(K), ref)
    gwas_t._PREP_CACHE.clear()
    _, _, Kd, _ = gwas_t._prep_device(g, p, device=CPU)
    v = gwas_t._grm_pc1_device(Kd).double().numpy()
    assert abs(v @ ref) / np.linalg.norm(v) >= 0.9999


def test_pc1_ramp_leaves_null_space(gwas_data):
    """ones/√n lies in the null space of C = Kc·Kcᵀ for a column-standardised
    K; the ramp start does not."""
    _, _, (g, p) = gwas_data
    gwas_t._PREP_CACHE.clear()
    _, _, K, _ = gwas_t._prep_device(g, p, device=CPU)
    K = K.double()
    Kc = K - K.mean(dim=1, keepdim=True)
    C = Kc @ Kc.T
    n = C.shape[0]
    norm = float(torch.linalg.matrix_norm(C, ord=2))
    ones = torch.ones(n, dtype=torch.float64) / n**0.5
    ramp = _ramp(n, torch.float64, "cpu")
    assert float(torch.linalg.norm(C @ ones)) / norm <= 1e-6
    assert float(torch.linalg.norm(C @ ramp)) / norm >= 1e-3


def test_gwasols_matches(gwas_data, gwas_scans):
    fj, ft = gwas_scans["gwasols"]
    assert ft.model == "GWAS_OLS" and ft.checkdims()
    assert np.array_equal(ft.b_hat_labels, fj.b_hat_labels)
    assert np.corrcoef(ft.b_hat, fj.b_hat)[0, 1] >= 0.99999
    assert np.abs(ft.b_hat - fj.b_hat).max() <= 1e-3 * np.abs(fj.b_hat).max()


def test_gwaslmm_matches(gwas_scans):
    """z cor >= 0.9999, the same argmax, and σ²ₑ + σ²ᵤ within 1e-3
    relative. The split itself is held on sim_small (next test): on this
    panel the null model's σ²ₑ/σ²ᵤ split lies on a flat ridge of the REML
    objective, where rounding differences of 1e-7 (the two preps' f32 GRMs
    lie ~2e-6·max|K| from the f64 one, each in its own way; the two LAPACK
    eighs; the two PC1 starts) move the split by ~0.3 % at a fixed sum.
    On identical rotated inputs the two scans agree to 4e-6
    (tests/test_torch_gblup.py::test_reml_scan_matches holds the scan)."""
    fj, ft = gwas_scans["gwaslmm"]
    assert ft.model == "GWAS_LMM" and np.all(np.isfinite(ft.b_hat))
    assert np.corrcoef(ft.b_hat, fj.b_hat)[0, 1] >= 0.9999
    assert np.argmax(np.abs(ft.b_hat)) == np.argmax(np.abs(fj.b_hat))
    total = lambda f: f.extras["sigma2_e"] + f.extras["sigma2_u"]  # noqa: E731
    assert total(ft) == pytest.approx(total(fj), rel=1e-3)


def test_gwaslmm_sigma2_on_sim_small(sim_small):
    """End to end on the continuous sim_small panel, where the REML split is
    well determined: σ²ₑ and σ²ᵤ within 1e-3 relative of the JAX package."""
    genomes, phenomes, _ = sim_small
    fj = gj.gwaslmm(genomes, phenomes)
    ft = gt.gwaslmm(convert.genomes_from_reference(genomes),
                    convert.phenomes_from_reference(phenomes), device=CPU)
    for k in ("sigma2_e", "sigma2_u"):
        assert ft.extras[k] == pytest.approx(fj.extras[k], rel=1e-3), k
    assert np.corrcoef(ft.b_hat, fj.b_hat)[0, 1] >= 0.9999


def test_gwasreml_matches(gwas_scans):
    fj, ft = gwas_scans["gwasreml"]
    assert ft.model == "GWAS_REML" and np.all(np.isfinite(ft.b_hat))
    assert np.corrcoef(ft.b_hat, fj.b_hat)[0, 1] >= 0.999
    assert np.argmax(np.abs(ft.b_hat)) == np.argmax(np.abs(fj.b_hat))
    assert {"prep+grm", "eigh+rotate", "reml_scan"} <= set(ft.extras["timings"])


def test_gwas_same_argmax_across_scans(gwas_scans):
    """The three scans put the same marker first, in the port as in JAX."""
    tops = {name: int(np.argmax(np.abs(ft.b_hat))) for name, (_, ft) in gwas_scans.items()}
    assert len(set(tops.values())) == 1, tops


def test_gwasreml_z_matches_f64_pinv_oracle(sim_small):
    """The port's gwasreml against the dense-pinv f64 oracle of the reference
    objective (no eigen-rotation; tests/test_parity_oracles.py), at
    PARITY.md's threshold: z cor >= 0.999 over the 12 strongest and 12
    spread markers, and the same strongest marker."""
    from test_parity_oracles import _oracle_reml_z

    genomes, phenomes, _ = sim_small
    sub = convert.genomes_from_reference(genomes.slice(idx_loci_alleles=np.arange(300)))
    p = convert.phenomes_from_reference(phenomes)
    fit = gt.gwasreml(sub, p, device=CPU)
    G, y, K, _ = gt.gwasprep(sub, p, device=CPU)
    K = (K + K.T) / 2.0  # the scans' symmetric-V objective
    top = np.argsort(-np.abs(fit.b_hat))[:12]
    rest = np.linspace(0, G.shape[1] - 1, 12).astype(int)
    marker_idx = np.unique(np.concatenate([top, rest]))
    z_o = _oracle_reml_z(y, G, K, marker_idx)
    z_d = fit.b_hat[marker_idx]
    assert np.corrcoef(z_d, z_o)[0, 1] >= 0.999
    assert np.argmax(np.abs(z_d)) == np.argmax(np.abs(z_o))


@pytest.mark.parametrize("name", ["gwasols", "gwaslmm", "gwasreml"])
def test_gwas_mesh_raises(gwas_data, name):
    # A mesh of one rank scans the markers as mesh=None does.
    from genomicbreedingmodels_tpu_torch.parallel.mesh import run_ranks

    _, _, (g, p) = gwas_data
    (one,) = run_ranks(lambda m: getattr(gt, name)(g, p, mesh=m), shape=(1, 1), device=CPU)
    ref = getattr(gt, name)(g, p, device=CPU)
    np.testing.assert_allclose(one.b_hat, ref.b_hat, rtol=0, atol=1e-6 * np.abs(ref.b_hat).max())


def test_gwas_errors(gwas_data):
    _, _, (g, p) = gwas_data
    with pytest.raises(ValueError, match="GRM_type"):
        gt.gwasprep(g, p, GRM_type="nope", device=CPU)
    with pytest.raises(ValueError, match="GRM_type"):
        gt.gwasols(g, p, GRM_type="nope", device=CPU)
