"""Command-line interface of the PyTorch port: fit / predict / cv / gwas / grm
straight from genotype + phenotype files.

    python -m genomicbreedingmodels_tpu_torch fit     --geno panel.bed --pheno y.tsv --model ridge --out fit.npz
    python -m genomicbreedingmodels_tpu_torch predict --geno panel.bed --fit fit.npz --out gebv.tsv
    python -m genomicbreedingmodels_tpu_torch cv      --geno panel.vcf --pheno y.tsv --models ridge,lasso,bayesa --out cvdir/
    python -m genomicbreedingmodels_tpu_torch gwas    --geno panel.tsv --pheno y.tsv --method reml --out hits.tsv
    python -m genomicbreedingmodels_tpu_torch grm     --geno panel.bed --out grm.npy [--streaming]

Port of genomicbreedingmodels_tpu/__main__.py: the same commands, arguments
and outputs, plus `--device` (default "cuda"; "cpu" runs the plain versions).
A `.npz` written by either package's `fit` loads in the other's `predict`.
Genotype format is inferred from the extension: `.bed` (PLINK trio prefix or
path to the .bed), `.vcf`/`.vcf.gz`, else the framework's TSV. `cv` and
`gwas` write their tables with pandas, imported only when they run.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np


def _load_genomes(path: str):
    from . import io as gio

    p = Path(path)
    name = p.name.lower()
    if name.endswith(".bed"):
        return gio.read_bed(p.with_suffix(""))
    if (p.with_suffix(".bed")).exists() and not p.exists():
        return gio.read_bed(p)  # trio prefix
    if name.endswith(".vcf") or name.endswith(".vcf.gz"):
        return gio.read_vcf(p)
    return gio.read_genomes_tsv(p)


def _entry_indices(genomes, phenomes):
    """Align phenome entries onto genome rows (by name)."""
    pos = {e: i for i, e in enumerate(genomes.entries)}
    missing = [e for e in phenomes.entries if e not in pos]
    if missing:
        raise SystemExit(
            f"error: {len(missing)} phenotyped entries absent from the genotype file "
            f"(first: {missing[:3]})"
        )
    return np.array([pos[e] for e in phenomes.entries], dtype=np.int64)


def _reorder_phenomes_to_genomes(genomes, phenomes):
    """Return a Phenomes row-aligned to genomes.entries (NaN where missing)."""
    from .core.structs import Phenomes

    pos = {e: i for i, e in enumerate(phenomes.entries)}
    n = len(genomes.entries)
    t = phenomes.phenotypes.shape[1]
    M = np.full((n, t), np.nan)
    for i, e in enumerate(genomes.entries):
        j = pos.get(e)
        if j is not None:
            M[i] = phenomes.phenotypes[j]
    return Phenomes(
        entries=genomes.entries.copy(),
        populations=genomes.populations.copy(),
        traits=phenomes.traits.copy(),
        phenotypes=M,
    )


def cmd_fit(a) -> int:
    from .cv.harness import _resolve_model

    genomes = _load_genomes(a.geno)
    from . import read_phenomes_tsv

    phenomes = _reorder_phenomes_to_genomes(genomes, read_phenomes_tsv(a.pheno))
    name, fn = _resolve_model(a.model)
    fit = fn(genomes=genomes, phenomes=phenomes, idx_trait=a.trait, device=a.device)
    np.savez(
        a.out,
        model=fit.model,
        trait=fit.trait,
        b_hat=fit.b_hat,
        b_hat_labels=np.asarray(fit.b_hat_labels, dtype=str),
        metrics=json.dumps({k: float(v) for k, v in fit.metrics.items()}),
    )
    print(json.dumps({"model": fit.model, "trait": fit.trait,
                      **{k: round(float(v), 6) for k, v in fit.metrics.items()}}))
    return 0


def cmd_predict(a) -> int:
    from .core.structs import Fit
    from .prediction import predict

    genomes = _load_genomes(a.geno)
    z = np.load(a.fit, allow_pickle=False)
    n = len(genomes.entries)
    fit = Fit(
        model=str(z["model"]),
        b_hat=z["b_hat"],
        b_hat_labels=z["b_hat_labels"].astype(object),
        trait=str(z["trait"]),
        entries=genomes.entries,
        populations=genomes.populations,
        y_true=np.zeros(n),
        y_pred=np.zeros(n),
        metrics=json.loads(str(z["metrics"])),
    )
    y_hat = predict(fit, genomes, idx_entries=list(range(n)), device=a.device)
    with open(a.out, "w") as fh:
        fh.write("entry\tpopulation\tgebv\n")
        for e, p, v in zip(genomes.entries, genomes.populations, y_hat):
            fh.write(f"{e}\t{p}\t{v:.10g}\n")
    print(json.dumps({"n": n, "out": str(a.out)}))
    return 0


def cmd_cv(a) -> int:
    from . import cvbulk, read_phenomes_tsv, summarise, tabularise

    genomes = _load_genomes(a.geno)
    phenomes = _reorder_phenomes_to_genomes(genomes, read_phenomes_tsv(a.pheno))
    models = [m.strip() for m in a.models.split(",") if m.strip()]
    cvs, notes = cvbulk(
        genomes=genomes, phenomes=phenomes, models=models,
        n_replications=a.replications, n_folds=a.folds, seed=a.seed, device=a.device,
    )
    out = Path(a.out)
    out.mkdir(parents=True, exist_ok=True)
    df_across, df_per_entry = tabularise(cvs)
    df_across.to_csv(out / "cv_across.tsv", sep="\t", index=False)
    df_per_entry.to_csv(out / "cv_per_entry.tsv", sep="\t", index=False)
    summ_across, summ_per_entry = summarise(cvs)
    summ_across.to_csv(out / "cv_summary.tsv", sep="\t", index=False)
    summ_per_entry.to_csv(out / "cv_summary_per_entry.tsv", sep="\t", index=False)
    (out / "notes.txt").write_text("\n".join(notes) + ("\n" if notes else ""))
    print(summ_across.to_string(index=False))
    return 0


def cmd_gwas(a) -> int:
    from . import gwaslmm, gwasols, gwasreml, manhattan_data, read_phenomes_tsv

    genomes = _load_genomes(a.geno)
    phenomes = _reorder_phenomes_to_genomes(genomes, read_phenomes_tsv(a.pheno))
    fn = {"ols": gwasols, "lmm": gwaslmm, "reml": gwasreml}[a.method]
    fit = fn(genomes=genomes, phenomes=phenomes, idx_trait=a.trait, GRM_type=a.grm_type,
             device=a.device)
    df = manhattan_data(fit)
    df.to_csv(a.out, sep="\t", index=False)
    top = df.nlargest(min(10, len(df)), "neg_log10_p")
    print(top.to_string(index=False))
    if a.plot:
        from .plots import plot_manhattan

        plot_manhattan(fit, save_path=a.plot)
    return 0


def cmd_grm(a) -> int:
    genomes_path = Path(a.geno)
    if a.streaming:
        if not genomes_path.name.lower().endswith(".bed"):
            genomes_path = genomes_path.with_suffix(".bed")
        from .streaming import grm_from_bed

        K = grm_from_bed(genomes_path.with_suffix(""), block_cols=a.block_cols, device=a.device)
    else:
        from .core.grm import grm_ploidy_aware, grm_simple, infer_ploidy

        genomes = _load_genomes(a.geno)
        if a.grm_type == "ploidy-aware":
            ploidy = infer_ploidy(genomes.allele_frequencies)
            K = grm_ploidy_aware(genomes, ploidy=ploidy, device=a.device)
        else:
            K = grm_simple(genomes, device=a.device)
        K = K.genomic_relationship_matrix
    K = K.cpu().numpy()
    out = Path(a.out)
    if out.suffix == ".npy":
        np.save(out, K)
    else:
        np.savetxt(out, K, delimiter="\t", fmt="%.8g")
    print(json.dumps({"shape": list(K.shape), "out": str(out)}))
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m genomicbreedingmodels_tpu_torch",
        description="genomic prediction on PyTorch: fit / predict / cv / gwas / grm",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    # Every command takes --device (after the command's name).
    dev = argparse.ArgumentParser(add_help=False)
    dev.add_argument("--device", default="cuda",
                     help='torch device to run on (default "cuda"; "cpu" runs the plain versions)')

    f = sub.add_parser("fit", parents=[dev], help="fit one model, save effects to .npz")
    f.add_argument("--geno", required=True)
    f.add_argument("--pheno", required=True)
    f.add_argument("--model", default="ridge")
    f.add_argument("--trait", type=int, default=0)
    f.add_argument("--out", required=True)
    f.set_defaults(fn=cmd_fit)

    p = sub.add_parser("predict", parents=[dev], help="predict GEBVs from a saved fit")
    p.add_argument("--geno", required=True)
    p.add_argument("--fit", required=True)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_predict)

    c = sub.add_parser("cv", parents=[dev], help="replicated k-fold cross-validation")
    c.add_argument("--geno", required=True)
    c.add_argument("--pheno", required=True)
    c.add_argument("--models", default="ridge")
    c.add_argument("--replications", type=int, default=5)
    c.add_argument("--folds", type=int, default=5)
    c.add_argument("--seed", type=int, default=42)
    c.add_argument("--out", required=True)
    c.set_defaults(fn=cmd_cv)

    g = sub.add_parser("gwas", parents=[dev], help="genome-wide association scan")
    g.add_argument("--geno", required=True)
    g.add_argument("--pheno", required=True)
    g.add_argument("--method", choices=("ols", "lmm", "reml"), default="reml")
    g.add_argument("--grm-type", dest="grm_type", default="simple")
    g.add_argument("--trait", type=int, default=0)
    g.add_argument("--out", required=True)
    g.add_argument("--plot", default=None)
    g.set_defaults(fn=cmd_gwas)

    k = sub.add_parser("grm", parents=[dev], help="genomic relationship matrix")
    k.add_argument("--geno", required=True)
    k.add_argument("--grm-type", dest="grm_type", default="simple")
    k.add_argument("--streaming", action="store_true",
                   help="out-of-core from .bed (never materializes the panel)")
    k.add_argument("--block-cols", dest="block_cols", type=int, default=32_768)
    k.add_argument("--out", required=True)
    k.set_defaults(fn=cmd_grm)

    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
