"""The port's IO layer (io.py) and its native codec (native/lib.py, its own
copy of gbmio.cpp) held against the JAX package's: files written by either
package read identically in the other (TSV genomes and phenomes, PLINK .bed
trios, VCF), `read_bed(marker_range=)`, the native decoders against the numpy
ones, and `write_random_bed` byte for byte. Every comparison is exact: both
packages print %.17g and decode the same 2-bit codes."""

import hashlib
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import genomicbreedingmodels_tpu as gj
import genomicbreedingmodels_tpu.io as io_jax
import genomicbreedingmodels_tpu_torch as gt
import genomicbreedingmodels_tpu_torch.io as io_port
from genomicbreedingmodels_tpu_torch import convert
from genomicbreedingmodels_tpu_torch.native import lib as native_port

REPO = Path(__file__).resolve().parent.parent


def _tree_digest(root: Path) -> dict:
    return {str(f.relative_to(root)): hashlib.sha256(f.read_bytes()).hexdigest()
            for f in sorted(root.rglob("*")) if f.is_file() and "__pycache__" not in f.parts}


def test_port_native_library_builds_its_own_source(tmp_path):
    """The port builds its own gbmio.cpp into a hash-named file under its
    build directory (here a temporary one), loads it with jax unimportable,
    and no file of the JAX package changes."""
    assert native_port.SRC.parent.parent == REPO / "genomicbreedingmodels_tpu_torch" / "native"
    assert native_port.BUILD_DIR == REPO / "build" / "gbm_torch_native"
    before = _tree_digest(REPO / "genomicbreedingmodels_tpu")
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        from pathlib import Path
        from genomicbreedingmodels_tpu_torch.native import lib
        lib.BUILD_DIR = Path({str(tmp_path)!r})
        out = lib.library_path()
        assert not out.exists()
        assert lib.load_native() is not None and out.is_file()
        assert not any(m == "genomicbreedingmodels_tpu" or m.startswith("genomicbreedingmodels_tpu.")
                       for m, mod in sys.modules.items() if mod is not None)
        print("built", out.name)
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         cwd=str(tmp_path), env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().startswith("built libgbmio_")
    assert [p.name for p in tmp_path.glob("*.so")] == [res.stdout.split()[-1]]
    assert _tree_digest(REPO / "genomicbreedingmodels_tpu") == before


def _panel(n, p, seed, missing=0.0, grid=True):
    rng = np.random.default_rng(seed)
    F = rng.choice([0.0, 0.5, 1.0], size=(n, p)) if grid else rng.uniform(size=(n, p))
    F[rng.random((n, p)) < missing] = np.nan
    return dict(entries=np.array([f"e{i}" for i in range(n)], dtype=object),
                populations=np.array([f"pop{i % 3}" for i in range(n)], dtype=object),
                loci_alleles=np.array([f"chrom_{1 + j % 4}\t{j + 1}\tA|T\tA" for j in range(p)],
                                      dtype=object),
                allele_frequencies=F)


def _same_genomes(a, b):
    assert np.array_equal(a.entries, b.entries)
    assert np.array_equal(a.populations, b.populations)
    assert np.array_equal(a.loci_alleles, b.loci_alleles)
    np.testing.assert_array_equal(a.allele_frequencies, b.allele_frequencies)


PKGS = {"jax": (gj, io_jax), "port": (gt, io_port)}


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax"), ("port", "port")])
@pytest.mark.parametrize("fmt", ["genomes_tsv", "phenomes_tsv", "bed"])
def test_files_cross_packages(tmp_path, writer, reader, fmt):
    """A file written by one package reads identically in the other (the
    exact panel, NaN where a call or a phenotype is missing)."""
    (wpkg, wio), (rpkg, rio) = PKGS[writer], PKGS[reader]
    if fmt == "phenomes_tsv":
        rng = np.random.default_rng(1)
        M = rng.normal(size=(23, 3))
        M[3, 1] = np.nan
        ph = wpkg.Phenomes(entries=np.array([f"e{i}" for i in range(23)], dtype=object),
                           populations=np.array(["p"] * 23, dtype=object),
                           traits=np.array(["t1", "t 2", "t\t3"], dtype=object), phenotypes=M)
        wio.write_phenomes_tsv(ph, tmp_path / "p.tsv")
        back = rio.read_phenomes_tsv(tmp_path / "p.tsv")
        assert np.array_equal(back.traits, ph.traits) and np.array_equal(back.entries, ph.entries)
        np.testing.assert_array_equal(back.phenotypes, M)
        return
    g = wpkg.Genomes(**_panel(37, 101, seed=2, missing=0.05, grid=fmt == "bed"))
    if fmt == "bed":
        wio.write_bed(g, tmp_path / "panel")
        back = rio.read_bed(tmp_path / "panel")
    else:
        wio.write_genomes_tsv(g, tmp_path / "g.tsv")
        back = rio.read_genomes_tsv(tmp_path / "g.tsv")
    _same_genomes(back, g)
    assert np.isnan(back.allele_frequencies).sum() > 0
    if writer != reader:  # byte-identical files from the two writers
        other = PKGS[reader][1]
        if fmt == "bed":
            other.write_bed(g, tmp_path / "again")
            for sfx in (".bed", ".bim", ".fam"):
                assert (tmp_path / "panel").with_suffix(sfx).read_bytes() == \
                    (tmp_path / "again").with_suffix(sfx).read_bytes()
        else:
            other.write_genomes_tsv(g, tmp_path / "again.tsv")
            assert (tmp_path / "g.tsv").read_bytes() == (tmp_path / "again.tsv").read_bytes()


@pytest.mark.parametrize("rng_range", [(0, 101), (10, 35), (100, 101), (50, 50)])
def test_read_bed_marker_range_matches_jax(tmp_path, rng_range):
    gj.write_bed(gj.Genomes(**_panel(21, 101, seed=3, missing=0.02)), tmp_path / "rng")
    a = io_jax.read_bed(tmp_path / "rng", marker_range=rng_range)
    b = io_port.read_bed(tmp_path / "rng", marker_range=rng_range)
    _same_genomes(b, a)
    assert b.p == rng_range[1] - rng_range[0]


def test_read_bed_marker_range_out_of_bounds(tmp_path):
    gt.write_bed(gt.Genomes(**_panel(21, 50, seed=3)), tmp_path / "rng")
    with pytest.raises(ValueError, match="out of bounds"):
        io_port.read_bed(tmp_path / "rng", marker_range=(40, 60))


def _write_vcf(path, n_samples=7, n_records=11, seed=0):
    rng = np.random.default_rng(seed)
    gts = ["0/0", "0/1", "1/1", "./.", "0|1", "1|1", "1/0", "./1"]
    with open(path, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n##source=test\n")
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                 + "\t".join(f"s{i}" for i in range(n_samples)) + "\n")
        for r in range(n_records):
            row = [gts[rng.integers(0, len(gts))] for _ in range(n_samples)]
            fmt = "GT:DP" if r % 2 else "GT"
            cells = [f"{g}:{rng.integers(5, 40)}" if r % 2 else g for g in row]
            fh.write(f"chr{1 + r % 2}\t{1000 + r}\trs{r}\tA\tG\t50\tPASS\t.\t{fmt}\t"
                     + "\t".join(cells) + "\n")


@pytest.mark.parametrize("native", [True, False])
def test_read_vcf_matches_jax(tmp_path, monkeypatch, native):
    """The port's VCF reader, native and numpy, equals the JAX package's."""
    _write_vcf(tmp_path / "panel.vcf")
    ref = io_jax.read_vcf(tmp_path / "panel.vcf", population="popA")
    if not native:
        monkeypatch.setattr(io_port, "load_native", lambda: None)
    got = io_port.read_vcf(tmp_path / "panel.vcf", population="popA")
    _same_genomes(got, ref)
    assert np.isnan(got.allele_frequencies).any()


@pytest.mark.parametrize("fmt", ["bed", "genomes_tsv"])
def test_native_and_numpy_codecs_agree(tmp_path, monkeypatch, fmt):
    """write_bed/read_bed and the TSV parser with and without the native
    library: the same files and the same panels, bit for bit."""
    g = gt.Genomes(**_panel(13, 33, seed=4, missing=0.1, grid=fmt == "bed"))
    out = {}
    for native in (True, False):
        if not native:
            monkeypatch.setattr(io_port, "load_native", lambda: None)
        stem = tmp_path / f"x{native}"
        if fmt == "bed":
            io_port.write_bed(g, stem)
            out[native] = (io_port.read_bed(stem), stem.with_suffix(".bed").read_bytes())
        else:
            io_port.write_genomes_tsv(g, stem.with_suffix(".tsv"))
            out[native] = (io_port.read_genomes_tsv(stem.with_suffix(".tsv")), b"")
    _same_genomes(out[True][0], out[False][0])
    assert out[True][1] == out[False][1]


def test_tsv_malformed_field_raises(tmp_path):
    path = tmp_path / "bad.tsv"
    path.write_text("entry\tpopulation\tl1\tl2\ne1\tp1\t0.5\toops\n")
    with pytest.raises(ValueError):
        io_port.read_genomes_tsv(path)


@pytest.mark.parametrize("n,p,chunk", [(13, 50, 64), (24, 31, 1 << 20)])
def test_write_random_bed_byte_identical_to_jax(tmp_path, n, p, chunk):
    """Same seed, same bytes (several chunks and the padded last byte of each
    SNP when n % 4 != 0); the trio reads back with complete calls."""
    io_jax.write_random_bed(tmp_path / "j", n, p, seed=5, chunk_bytes=chunk)
    io_port.write_random_bed(tmp_path / "t", n, p, seed=5, chunk_bytes=chunk)
    for sfx in (".bed", ".bim", ".fam"):
        assert (tmp_path / "j").with_suffix(sfx).read_bytes() == \
            (tmp_path / "t").with_suffix(sfx).read_bytes()
    g = io_port.read_bed(tmp_path / "t")
    assert g.n == n and g.p == p and np.isfinite(g.allele_frequencies).all()


def test_io_feeds_port_models(tmp_path):
    """Files written by the JAX package drive the port's fit on the CPU to
    the same accuracy as the panel held in memory."""
    genomes = gj.simulate_genomes(n=60, l=300, seed=4)
    trials, _ = gj.simulate_trials(genomes, f_add_dom_epi=np.array([[0.5, 0.05, 0.05]]), seed=4)
    phenomes = gj.extract_phenomes(trials)
    gj.write_genomes_tsv(genomes, tmp_path / "g.tsv")
    gj.write_phenomes_tsv(phenomes, tmp_path / "p.tsv")
    fit = gt.ridge(gt.read_genomes_tsv(tmp_path / "g.tsv"), gt.read_phenomes_tsv(tmp_path / "p.tsv"),
                   device="cpu")
    ref = gt.ridge(convert.genomes_from_reference(genomes), convert.phenomes_from_reference(phenomes),
                   device="cpu")
    np.testing.assert_array_equal(fit.b_hat, ref.b_hat)
