"""Genomic panel IO: TSV genomes/phenomes, PLINK .bed trios and VCF.

Port of genomicbreedingmodels_tpu/io.py: host code over numpy and the port's
own native C++ codec (native/src/gbmio.cpp: multithreaded std::from_chars
TSV parsing, the 2-bit .bed codec, the VCF GT parser); metadata columns stay
in Python. Every entry point works without the native library via numpy
fallbacks. Files written by either package read identically in the other.

Formats
-------
Genomes TSV: header `entry<TAB>population<TAB><locus-allele...>`, one row per
entry, frequencies printed with %.17g so a write/read round-trip is bit-exact.
Phenomes TSV: header `entry<TAB>population<TAB><trait...>`.
PLINK trio: `.bed` (2-bit SNP-major genotypes; frequencies snapped to
{0, 0.5, 1}, NaN <-> missing), `.fam` (entries; population in FID), `.bim`
(loci: chrom, id, 0, pos, A1, A2).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Union

import numpy as np

from .core.structs import Genomes, Phenomes
from .native.lib import load_native

__all__ = [
    "write_genomes_tsv",
    "read_genomes_tsv",
    "write_phenomes_tsv",
    "read_phenomes_tsv",
    "write_bed",
    "read_bed",
    "read_vcf",
    "write_random_bed",
]

_BED_MAGIC = bytes([0x6C, 0x1B, 0x01])


def _escape(name: str) -> str:
    """Locus-allele names embed tabs (reference format
    'chrom<TAB>pos<TAB>alleles<TAB>allele'); escape them for tabular files."""
    return str(name).replace("\\", "\\\\").replace("\t", "\\t")


def _unescape(name: str) -> str:
    out, i = [], 0
    while i < len(name):
        if name[i] == "\\" and i + 1 < len(name):
            out.append("\t" if name[i + 1] == "t" else name[i + 1])
            i += 2
        else:
            out.append(name[i])
            i += 1
    return "".join(out)


# ---------------------------------------------------------------------------
# TSV
# ---------------------------------------------------------------------------


def _write_table(path: Path, header: list, names, populations, M: np.ndarray) -> None:
    with open(path, "w") as fh:
        fh.write("\t".join(header) + "\n")
        for i in range(M.shape[0]):
            vals = "\t".join("%.17g" % v if np.isfinite(v) else "NA" for v in M[i])
            fh.write(f"{names[i]}\t{populations[i]}\t{vals}\n")


def _parse_table(path: Path):
    """Returns (entries, populations, column_names, matrix). Native C++ parse
    of the numeric block when available, numpy fallback otherwise."""
    with open(path, "r") as fh:
        header = fh.readline().rstrip("\n").split("\t")
    if len(header) < 3 or header[0] != "entry" or header[1] != "population":
        raise ValueError(f"{path}: expected header 'entry\\tpopulation\\t<columns...>'")
    col_names = np.asarray([_unescape(h) for h in header[2:]], dtype=object)
    n_cols = len(col_names)

    lib = load_native()
    if lib is not None:
        import ctypes

        n_rows_c = ctypes.c_long()
        n_cols_c = ctypes.c_long()
        rc = lib.gbmio_tsv_dims(str(path).encode(), ctypes.byref(n_rows_c), ctypes.byref(n_cols_c))
        if rc != 0:
            raise OSError(f"cannot read {path}")
        n = n_rows_c.value - 1
        if n_cols_c.value != n_cols + 2:
            raise ValueError(
                f"{path}: header declares {n_cols} data columns but first row has "
                f"{n_cols_c.value - 2}"
            )
        M = np.empty((n, n_cols), dtype=np.float64)
        bad = ctypes.c_long()
        rc = lib.gbmio_tsv_parse(
            str(path).encode(), 1, 2,
            M.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            n, n_cols, 0, ctypes.byref(bad),
        )
        if rc == -3:
            raise ValueError(f"{path}: malformed numeric field at data row {bad.value}")
        if rc != 0:
            raise ValueError(f"{path}: parse failed (code {rc})")
        meta = np.loadtxt(path, dtype=str, delimiter="\t", skiprows=1, usecols=(0, 1), ndmin=2)
    else:
        raw = np.loadtxt(path, dtype=str, delimiter="\t", skiprows=1, ndmin=2)
        meta = raw[:, :2]
        M = np.where(raw[:, 2:] == "NA", "nan", raw[:, 2:]).astype(np.float64)
    entries = meta[:, 0].astype(object)
    populations = meta[:, 1].astype(object)
    return entries, populations, col_names, M


def write_genomes_tsv(genomes: Genomes, path: Union[str, os.PathLike]) -> None:
    path = Path(path)
    header = ["entry", "population"] + [_escape(x) for x in genomes.loci_alleles]
    _write_table(path, header, genomes.entries, genomes.populations, genomes.allele_frequencies)


def read_genomes_tsv(path: Union[str, os.PathLike]) -> Genomes:
    entries, populations, loci_alleles, M = _parse_table(Path(path))
    g = Genomes(
        entries=entries, populations=populations, loci_alleles=loci_alleles,
        allele_frequencies=M,
    )
    if not g.checkdims():
        raise ValueError(f"{path}: inconsistent genomes table")
    return g


def write_phenomes_tsv(phenomes: Phenomes, path: Union[str, os.PathLike]) -> None:
    path = Path(path)
    header = ["entry", "population"] + [_escape(x) for x in phenomes.traits]
    _write_table(path, header, phenomes.entries, phenomes.populations, phenomes.phenotypes)


def read_phenomes_tsv(path: Union[str, os.PathLike]) -> Phenomes:
    entries, populations, traits, M = _parse_table(Path(path))
    ph = Phenomes(entries=entries, populations=populations, traits=traits, phenotypes=M)
    if not ph.checkdims():
        raise ValueError(f"{path}: inconsistent phenomes table")
    return ph


# ---------------------------------------------------------------------------
# PLINK .bed trio
# ---------------------------------------------------------------------------


def _parse_locus_name(name: str):
    """'chrom_1\\t12345\\tA|T\\tA' -> (chrom, pos, a1, a2); tolerant of plain ids."""
    parts = str(name).split("\t")
    if len(parts) == 4:
        chrom = parts[0].replace("chrom_", "")
        alleles = parts[2].split("|")
        a2 = parts[3]
        a1 = next((a for a in alleles if a != a2), alleles[0] if alleles else "N")
        return chrom, parts[1], a2, a1
    return "0", "0", "A", "T"


def write_bed(genomes: Genomes, prefix: Union[str, os.PathLike]) -> None:
    """Write `<prefix>.bed/.fam/.bim`. Frequencies snap to {0, 0.5, 1}."""
    prefix = Path(prefix)
    n, p = genomes.allele_frequencies.shape
    bytes_per_snp = (n + 3) // 4
    payload = np.zeros(bytes_per_snp * p, dtype=np.uint8)
    F = np.ascontiguousarray(genomes.allele_frequencies, dtype=np.float64)
    lib = load_native()
    if lib is not None:
        import ctypes

        lib.gbmio_bed_encode(
            F.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n, p,
            payload.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), 0,
        )
    else:
        codes = np.where(np.isnan(F), 1, np.where(F < 0.25, 0, np.where(F < 0.75, 2, 3))).astype(np.uint8)
        for s in range(p):
            col = codes[:, s]
            padded = np.zeros(bytes_per_snp * 4, dtype=np.uint8)
            padded[:n] = col
            quads = padded.reshape(-1, 4)
            packed = quads[:, 0] | (quads[:, 1] << 2) | (quads[:, 2] << 4) | (quads[:, 3] << 6)
            payload[s * bytes_per_snp : (s + 1) * bytes_per_snp] = packed
    with open(prefix.with_suffix(".bed"), "wb") as fh:
        fh.write(_BED_MAGIC)
        fh.write(payload.tobytes())
    with open(prefix.with_suffix(".fam"), "w") as fh:
        for ent, pop in zip(genomes.entries, genomes.populations):
            fh.write(f"{pop}\t{ent}\t0\t0\t0\t-9\n")
    with open(prefix.with_suffix(".bim"), "w") as fh:
        for name in genomes.loci_alleles:
            chrom, pos, a1, a2 = _parse_locus_name(name)
            fh.write(f"{chrom}\t{_escape(name)}\t0\t{pos}\t{a1}\t{a2}\n")


def write_random_bed(
    prefix: Union[str, os.PathLike],
    n: int,
    p: int,
    seed: int = 7,
    chunk_bytes: int = 256 * 1024 * 1024,
    progress: bool = False,
) -> None:
    """Write an at-scale synthetic PLINK trio with COMPLETE diploid calls.

    Genotype bytes are synthesized straight from an 81-entry valid-byte LUT
    (all four 2-bit fields in {00, 10, 11} — the missing code 01 never
    appears, so the exact int8 dosage / packed-payload paths of streaming.py
    apply), one RNG pass + one gather per chunk — the float panel never
    exists. Padding bit-pairs of each SNP's last byte are zeroed per the
    PLINK spec and a minimal `.bim`/.fam are written, so the trio also loads
    in external tools. Byte-identical to the JAX package's for the same
    arguments; chip_smoke.py phase 15 (b) streams such a file.
    """
    import sys

    prefix = Path(prefix)
    valid_codes = (0, 2, 3)  # hom A1 / het / hom A2; 1 = missing, excluded
    lut = np.array(
        [
            a | (b << 2) | (c << 4) | (d << 6)
            for a in valid_codes
            for b in valid_codes
            for c in valid_codes
            for d in valid_codes
        ],
        dtype=np.uint8,
    )
    bytes_per_snp = (n + 3) // 4
    total = bytes_per_snp * p
    pad = n % 4
    tail_mask = np.uint8((1 << (2 * pad)) - 1) if pad else np.uint8(0xFF)
    rng = np.random.default_rng(seed)
    with open(prefix.with_suffix(".bed"), "wb") as fh:
        fh.write(_BED_MAGIC)
        written = 0
        while written < total:
            m = min(chunk_bytes, total - written)
            buf = lut[rng.integers(0, len(lut), size=m, dtype=np.uint8)]
            if pad:
                pos = written + np.arange(m, dtype=np.int64)
                buf[pos % bytes_per_snp == bytes_per_snp - 1] &= tail_mask
            fh.write(buf.tobytes())
            written += m
            if progress:
                print(f"\r{written / total:6.1%}", end="", file=sys.stderr, flush=True)
    if progress:
        print(file=sys.stderr)
    with open(prefix.with_suffix(".fam"), "w") as fh:
        fh.writelines(f"pop_1\te{i:06d}\t0\t0\t0\t-9\n" for i in range(n))
    with open(prefix.with_suffix(".bim"), "w") as fh:
        fh.writelines(f"1\tsnp{i:07d}\t0\t{i + 1}\tA\tT\n" for i in range(p))


def read_bed(
    prefix: Union[str, os.PathLike],
    marker_range: "tuple[int, int] | None" = None,
) -> Genomes:
    """Read a `<prefix>.bed/.fam/.bim` trio into a Genomes struct.

    `marker_range=(start, stop)` reads only that column slice of the .bed
    payload (a contiguous byte range — SNP-major layout), so each host of a
    multi-process run can load just its shard. At size, stream the file
    (streaming.BedShardStreamer) instead: the f64 panel is 8 bytes a call.
    """
    prefix = Path(prefix)
    fam = np.loadtxt(prefix.with_suffix(".fam"), dtype=str, delimiter="\t", ndmin=2)
    bim = np.loadtxt(prefix.with_suffix(".bim"), dtype=str, delimiter="\t", ndmin=2)
    entries = fam[:, 1].astype(object)
    populations = fam[:, 0].astype(object)
    loci_alleles = np.asarray([_unescape(x) for x in bim[:, 1]], dtype=object)
    n, p_total = len(entries), len(loci_alleles)
    bytes_per_snp = (n + 3) // 4
    bed_path = prefix.with_suffix(".bed")
    if marker_range is not None:
        start, stop = int(marker_range[0]), int(marker_range[1])
        if not (0 <= start <= stop <= p_total):
            raise ValueError(f"marker_range {marker_range} out of bounds for {p_total} markers")
        p = stop - start
        loci_alleles = loci_alleles[start:stop]
        with open(bed_path, "rb") as fh:
            if fh.read(3) != _BED_MAGIC:
                raise ValueError(f"{bed_path}: bad PLINK magic (or sample-major, unsupported)")
            fh.seek(3 + start * bytes_per_snp)
            payload = np.frombuffer(fh.read(p * bytes_per_snp), dtype=np.uint8)
        payload = np.ascontiguousarray(payload)
    else:
        p = p_total
        raw = np.fromfile(bed_path, dtype=np.uint8)
        if raw[:3].tobytes() != _BED_MAGIC:
            raise ValueError(f"{bed_path}: bad PLINK magic (or sample-major, unsupported)")
        payload = np.ascontiguousarray(raw[3:])
    if len(payload) < bytes_per_snp * p:
        raise ValueError(f"{bed_path}: truncated payload")
    F = np.empty((n, p), dtype=np.float64)
    lib = load_native()
    if lib is not None:
        import ctypes

        lib.gbmio_bed_decode(
            payload.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n, p,
            F.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), 0,
        )
    else:
        lut = np.array([0.0, np.nan, 0.5, 1.0])
        cols = payload[: bytes_per_snp * p].reshape(p, bytes_per_snp)
        codes = np.stack(
            [(cols >> shift) & 0x3 for shift in (0, 2, 4, 6)], axis=-1
        ).reshape(p, -1)[:, :n]
        F[:] = lut[codes].T
    g = Genomes(
        entries=entries, populations=populations, loci_alleles=loci_alleles,
        allele_frequencies=F,
    )
    if not g.checkdims():
        raise ValueError(f"{prefix}: inconsistent PLINK trio")
    return g


# ---------------------------------------------------------------------------
# VCF (single-ALT diploid GT records)
# ---------------------------------------------------------------------------


def read_vcf(path: Union[str, os.PathLike], population: str = "unknown") -> Genomes:
    """Read a VCF into a Genomes struct (GT dosage / 2 as allele frequency).

    Supports the common genomic-prediction case: diploid GT first in FORMAT,
    one ALT per record ('0/0' -> 0.0, het -> 0.5, '1/1' -> 1.0, missing ->
    NaN; '/' and '|' separators). Locus names use the framework's
    'chrom<TAB>pos<TAB>REF|ALT<TAB>ALT' convention so GWAS plots and .bed
    round-trips work. Native C++ GT parser with a pure-Python fallback.
    """
    path = Path(path)
    samples = None
    meta = []
    with open(path, "r") as fh:
        for line in fh:
            if line.startswith("##"):
                continue
            if line.startswith("#CHROM"):
                samples = line.rstrip("\n").split("\t")[9:]
                continue
            parts = line.rstrip("\n").split("\t", 5)
            if len(parts) < 5:
                raise ValueError(f"{path}: malformed VCF record: {line[:60]!r}")
            meta.append((parts[0], parts[1], parts[3], parts[4]))
    if samples is None:
        raise ValueError(f"{path}: no #CHROM header line")
    n, p = len(samples), len(meta)
    if p == 0:
        raise ValueError(f"{path}: no records")

    lib = load_native()
    F = np.empty((n, p), dtype=np.float64)
    if lib is not None:
        import ctypes

        nr, ns, hdr = ctypes.c_long(), ctypes.c_long(), ctypes.c_long()
        rc = lib.gbmio_vcf_dims(str(path).encode(), ctypes.byref(nr), ctypes.byref(ns), ctypes.byref(hdr))
        if rc != 0 or nr.value != p or ns.value != n:
            raise ValueError(f"{path}: VCF dims mismatch (rc={rc}, {nr.value}x{ns.value} vs {p}x{n})")
        bad = ctypes.c_long()
        rc = lib.gbmio_vcf_parse(
            str(path).encode(), F.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            p, n, 0, ctypes.byref(bad),
        )
        if rc != 0:
            raise ValueError(f"{path}: VCF parse failed (rc={rc}, record {bad.value})")
    else:
        with open(path, "r") as fh:
            r = 0
            for line in fh:
                if line.startswith("#"):
                    continue
                fields = line.rstrip("\n").split("\t")
                for s_i, field in enumerate(fields[9 : 9 + n]):
                    gt = field.split(":", 1)[0].replace("|", "/")
                    alleles = gt.split("/")
                    if any(a in (".", "") for a in alleles):
                        F[s_i, r] = np.nan
                    else:
                        alt = sum(1 for a in alleles if int(a) > 0)
                        F[s_i, r] = min(alt, 2) * 0.5
                r += 1

    loci_alleles = np.asarray(
        [f"{c}\t{pos}\t{ref}|{alt}\t{alt}" for c, pos, ref, alt in meta], dtype=object
    )
    g = Genomes(
        entries=np.asarray(samples, dtype=object),
        populations=np.asarray([population] * n, dtype=object),
        loci_alleles=loci_alleles,
        allele_frequencies=F,
    )
    if not g.checkdims():
        raise ValueError(f"{path}: inconsistent VCF panel")
    return g
