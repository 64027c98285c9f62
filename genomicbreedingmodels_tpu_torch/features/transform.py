"""Epistasis feature engineering, torch port of
genomicbreedingmodels_tpu/features/transform.py (reference
src/transformation.jl).

- `transform1` (reference :130-238): the per-feature effect is the
  closed-form simple-regression slope β = Σ(t-t̄)(y-ȳ)/Σ(t-t̄)², computed for
  every transformed column in one batched device pass.
- `transform2` (reference :319-468): the l² ordered-pair scan. For `mult` and
  `addnorm` each 128-row chunk of the pair matrix scores its slopes by three
  matrix products against the whole panel and merges them into a running
  top-k on the device; only k (value, row, col) triples come back to the
  host, once. Other transforms materialize each block's pair tensor. The
  scan is XLA in the reference, so plain torch products are its port.
- `epistasisfeatures` (reference :540-668): n_reps rounds over the unary +
  binary transformation sets, appending deduplicated features.
- `reconstitutefeatures` (reference :730-778): feature-name strings are
  parsed once into expression trees and evaluated vectorized over entries
  (same serialization format, no eval), on the host in float64.

Top-k ties: `lax.top_k` puts the lower index first among equal values, and
the JAX scan's selections follow from that at every stage (per row, per
chunk, against the running top-k). `torch.topk` promises no order among
ties, so `_topk_lower` ranks a unique int64 key, the value's float bits
above the inverted index, which reproduces the rule exactly.
"""

from __future__ import annotations

import math
import warnings
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..core.structs import Genomes, Phenomes
from ..device import resolve_device
from ..prediction import extractxyetc
from ..utils.devcache import SingleSlotCache, host_fingerprint
from .endofunctions import BINARY_DEFAULTS, FUNCTION_REGISTRY, UNARY_DEFAULTS, registry_name

# Padded device panel of the most recent transform2 GEMM scan.
_T2_PANEL_CACHE = SingleSlotCache()

__all__ = [
    "transform1",
    "transform2",
    "epistasisfeatures",
    "reconstitutefeatures",
    "parse_feature_name",
]

_EPS = np.finfo(np.float64).eps
_ROWS_PER_CHUNK = 128


def _slopes(T: np.ndarray, y: np.ndarray, var_threshold: float, dev) -> np.ndarray:
    """Simple-regression slopes of y on each column of T (batched, device, f32)."""
    Tt = torch.as_tensor(np.asarray(T, dtype=np.float32), device=dev)
    yt = torch.as_tensor(np.asarray(y, dtype=np.float32), device=dev)
    Tm = Tt - Tt.mean(0, keepdim=True)
    ym = yt - yt.mean()
    ss = (Tm * Tm).sum(0)
    beta = (Tm.T @ ym) / torch.clamp(ss, min=1e-30)
    var = ss / max(Tt.shape[0] - 1, 1)
    beta = beta.double().cpu().numpy()
    beta[var.cpu().numpy() < var_threshold] = 0.0
    return beta


def _snap(T: np.ndarray, eps: float) -> np.ndarray:
    T = T.copy()
    T[np.abs(T) < eps] = 0.0
    T[np.abs(T - 1.0) < eps] = 1.0
    return T


def _input_var_mask(X: np.ndarray, threshold: float) -> np.ndarray:
    return np.var(X, axis=0, ddof=1) >= threshold


def transform1(
    f: Callable,
    genomes: Genomes,
    phenomes: Phenomes,
    idx_trait: int = 0,
    idx_entries: Optional[Sequence[int]] = None,
    idx_loci_alleles: Optional[Sequence[int]] = None,
    n_new_features_per_transformation: int = 1_000,
    eps: float = _EPS,
    use_abs: bool = False,
    var_threshold: float = 0.01,
    verbose: bool = False,
    device="cuda",
) -> Genomes:
    """Apply a unary transform to every locus, rank by single-locus effect
    (reference src/transformation.jl:130-238), the slopes on `device`. Skip
    criterion: INPUT column variance < var_threshold, as in the reference
    (:181)."""
    dev = resolve_device(device)
    X, y, entries, populations, loci_alleles = extractxyetc(
        genomes, phenomes, idx_entries=idx_entries, idx_loci_alleles=idx_loci_alleles,
        idx_trait=idx_trait, add_intercept=False,
    )
    X = X + eps
    if use_abs:
        X = np.abs(X)
    try:
        T = np.asarray(f(X), dtype=np.float64)
    except Exception as err:
        raise ValueError(
            f"cannot transform allele frequencies with {registry_name(f)!r}: {err}; "
            "the function must accept a single array argument"
        ) from err
    beta = _slopes(T, y, 0.0, dev)
    beta[~_input_var_mask(X, var_threshold)] = 0.0
    order = np.argsort(-np.abs(beta), kind="stable")[:n_new_features_per_transformation]
    keep = order[np.abs(beta[order]) > eps]
    Tk = _snap(T[:, keep], eps)
    fname = registry_name(f)
    names = np.asarray([f"{fname}({loc})" for loc in loci_alleles[keep]], dtype=object)
    out = Genomes(
        entries=entries, populations=populations, loci_alleles=names, allele_frequencies=Tk
    )
    if not out.checkdims():
        raise RuntimeError(f"error transforming loci with {fname!r}")
    return out


def _topk_lower(v: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of each row of v (non-negative, no
    NaN), largest first, equal values in the order of their index: the
    order of `lax.top_k`. The key is the value's float bits (order-keeping
    for non-negative floats) above the inverted index, so every key is
    unique and `torch.topk` has no tie to break."""
    L = v.shape[-1]
    inv = (L - 1) - torch.arange(L, device=v.device)
    key = v.contiguous().view(torch.int32).to(torch.int64) * (1 << 32) + inv
    return torch.topk(key, k, dim=-1, sorted=True).indices


def _beta_mask_topk(beta, okb, okall, row0: int, commutative: bool, k: int):
    """Zero masked/lower-triangle slopes, then the block's top-k |slope| on
    the device, as (values, row·l + col indices within the block). Exact
    two-stage form (per row, then across rows) when k < l."""
    bi, l = beta.shape
    beta = torch.where(okb[:, None] & okall[None, :], beta, 0.0)
    if commutative:
        rows = row0 + torch.arange(bi, device=beta.device)
        beta = torch.where(torch.arange(l, device=beta.device)[None, :] < rows[:, None], 0.0, beta)
    k_row = min(k, l)
    if k_row < l:
        idx_r = _topk_lower(beta.abs(), k_row)  # (bi, k_row)
        flat_idx = (torch.arange(bi, device=beta.device)[:, None] * l + idx_r).reshape(-1)
        cand = beta.gather(1, idx_r).reshape(-1)
        sel = _topk_lower(cand.abs()[None], k)[0]
        return cand[sel], flat_idx[sel]
    flat = beta.reshape(-1)
    idx = _topk_lower(flat.abs()[None], k)[0]
    return flat[idx], idx


def _generic_block_topk(Xblk, Xj, ymj, okb, okall, row0: int, f: Callable, commutative: bool,
                        k: int):
    """Arbitrary binary transform: materialize the block's (n, bi·l) pair
    tensor and run one batched slope pass."""
    n = Xj.shape[0]
    P = f(Xblk[:, :, None], Xj[:, None, :]).reshape(n, -1)
    Pm = P - P.mean(0, keepdim=True)
    ss = (Pm * Pm).sum(0)
    beta = (Pm.T @ ymj) / torch.clamp(ss, min=1e-30)
    return _beta_mask_topk(beta.reshape(Xblk.shape[1], -1), okb, okall, row0, commutative, k)


def _chunk_topk_scan(Xl, Xfull, ym, okl, okfull, row_dev0: int, *, kern_name: str,
                     commutative: bool, k: int, rows_per_chunk: int):
    """A row range's whole pair scan on the device: each chunk of
    `rows_per_chunk` rows scores its (rc × l_pad) slopes by the GEMM formula
    and merges them into the running top-k; returns the k (value, row, col)
    triples, rows and cols as two int32 tensors (a flat l_pad² index would
    overflow int32 past l ≈ 46k). The chunk's top-k is the exact two-stage
    form (per row, then across rows), every stage with `lax.top_k`'s
    lower-index rule, and the carry is merged before the chunk, so the
    selections are the JAX scan's (transform.py:200-293)."""
    n = Xl.shape[0]
    l_pad = Xfull.shape[1]
    dev = Xfull.device
    rc = rows_per_chunk
    n_chunks = Xl.shape[1] // rc
    k_row = min(k, l_pad)
    cols = torch.arange(l_pad, device=dev)
    if kern_name == "mult":
        X2 = Xfull * Xfull
    else:  # addnorm
        u = Xfull.T @ ym
        s = Xfull.sum(0)
        q = (Xfull * Xfull).sum(0)
    tv = torch.zeros(k, dtype=torch.float32, device=dev)
    tr = torch.zeros(k, dtype=torch.int32, device=dev)
    tc = torch.zeros(k, dtype=torch.int32, device=dev)
    for c in range(n_chunks):
        r0 = c * rc
        Xblk = Xl[:, r0 : r0 + rc]
        okb = okl[r0 : r0 + rc]
        row0 = row_dev0 + r0
        S1 = Xblk.T @ Xfull
        if kern_name == "mult":
            Nm = (Xblk * ym[:, None]).T @ Xfull
            Q = (Xblk * Xblk).T @ X2
            den = Q - S1 * S1 / n  # the JAX formula, in float32
            beta = Nm / torch.clamp(den, min=1e-30)
        else:
            ub, sb, qb = u[row0 : row0 + rc], s[row0 : row0 + rc], q[row0 : row0 + rc]
            num = 0.5 * (ub[:, None] + u[None, :])
            st = 0.5 * (sb[:, None] + s[None, :])
            st2 = 0.25 * (qb[:, None] + 2.0 * S1 + q[None, :])
            den = st2 - st * st / n
            beta = num / torch.clamp(den, min=1e-30)
        beta = torch.where(okb[:, None] & okfull[None, :], beta, 0.0)
        if commutative:
            rows = row0 + torch.arange(rc, device=dev)
            beta = torch.where(cols[None, :] < rows[:, None], 0.0, beta)
        idx_r = _topk_lower(beta.abs(), k_row)  # (rc, k_row)
        cand = beta.gather(1, idx_r).reshape(-1)
        sel0 = _topk_lower(cand.abs()[None], min(k, rc * k_row))[0]
        grow = (row0 + torch.div(sel0, k_row, rounding_mode="floor")).to(torch.int32)
        gcol = idx_r.reshape(-1)[sel0].to(torch.int32)
        cv = cand[sel0]
        pad = k - cv.shape[0]
        if pad > 0:
            cv = torch.cat([cv, torch.zeros(pad, dtype=torch.float32, device=dev)])
            grow = torch.cat([grow, torch.zeros(pad, dtype=torch.int32, device=dev)])
            gcol = torch.cat([gcol, torch.zeros(pad, dtype=torch.int32, device=dev)])
        mv, mr, mc = torch.cat([tv, cv]), torch.cat([tr, grow]), torch.cat([tc, gcol])
        sel = _topk_lower(mv.abs()[None], k)[0]
        tv, tr, tc = mv[sel], mr[sel], mc[sel]
    return tv, tr, tc


def transform2(
    f: Callable,
    genomes: Genomes,
    phenomes: Phenomes,
    idx_trait: int = 0,
    idx_entries: Optional[Sequence[int]] = None,
    idx_loci_alleles: Optional[Sequence[int]] = None,
    n_new_features_per_transformation: int = 1_000,
    eps: float = _EPS,
    use_abs: bool = False,
    var_threshold: float = 0.01,
    commutative: bool = False,
    block: int = 64,
    mesh=None,
    verbose: bool = False,
    device="cuda",
) -> Genomes:
    """Apply a binary transform to every ordered locus pair, rank effects
    (reference src/transformation.jl:319-468), the scan on `device`. `mult`
    and `addnorm` run the chunked GEMM scan with a running top-k on the
    device and one read-back; other transforms run a block loop that
    materializes each block's pairs.

    With `mesh` (parallel/mesh.py; every rank calls with the same
    arguments) and `mult`/`addnorm`, the pair matrix's rows are split over
    the mesh's last axis (JAX `_pairs_topk_sharded`): each rank scans its
    range of rows against the whole panel on its mesh device with its own
    running top-k, the D·k candidates are gathered, and the merge keeps
    the lower index on ties, as the single scan does; every rank returns
    the same features. Other transforms run the single-device loop on the
    rank's device."""
    dev = resolve_device(device) if mesh is None else mesh.device
    D = 1 if mesh is None else mesh.shape[mesh.axis_names[-1]]
    X, y, entries, populations, loci_alleles = extractxyetc(
        genomes, phenomes, idx_entries=idx_entries, idx_loci_alleles=idx_loci_alleles,
        idx_trait=idx_trait, add_intercept=False,
    )
    X = X + eps
    if use_abs:
        X = np.abs(X)
    n, l = X.shape
    ok = _input_var_mask(X, var_threshold)
    k_cap = int(n_new_features_per_transformation)
    ym = torch.as_tensor((y - y.mean()).astype(np.float32), device=dev)
    fname_dispatch = registry_name(f)

    if fname_dispatch in ("mult", "addnorm"):
        rc = _ROWS_PER_CHUNK
        l_pad = int(math.ceil(l / (D * rc)) * D * rc)
        # Repeated scans on one panel (epistasisfeatures' rounds, warm
        # benches) reuse the padded device panel (utils/devcache.py).
        fp = (host_fingerprint(X), l_pad, "t2", str(dev))
        Xdev = _T2_PANEL_CACHE.get(fp)
        if Xdev is None:
            Xpad = np.zeros((n, l_pad), dtype=np.float32)
            Xpad[:, :l] = X
            Xdev = _T2_PANEL_CACHE.put(fp, torch.as_tensor(Xpad, device=dev))
        okpad = np.zeros(l_pad, dtype=bool)
        okpad[:l] = ok
        okd = torch.as_tensor(okpad, device=dev)
        k = int(min(k_cap, rc * l_pad))
        if k < k_cap and l * l > k:
            # The running top-k holds rc*l_pad candidates; a request beyond
            # that would silently truncate, so say so (the caller still gets
            # the best k of all pairs).
            warnings.warn(
                f"transform2: n_new_features_per_transformation={k_cap} exceeds "
                f"the GEMM scan's running top-k capacity {k} (= {rc}*l_pad); "
                f"returning the top {k} pairs only",
                RuntimeWarning,
                stacklevel=2,
            )
        lp = l_pad // D  # this rank's rows of the pair matrix
        r0 = 0 if D == 1 else mesh.index(mesh.axis_names[-1]) * lp
        tv, tr, tc = _chunk_topk_scan(Xdev[:, r0 : r0 + lp], Xdev, ym, okd[r0 : r0 + lp], okd, r0,
                                      kern_name=fname_dispatch, commutative=commutative, k=k,
                                      rows_per_chunk=rc)
        if D > 1:  # rank-ordered, so equal values keep the lower rows first
            ax = mesh.axis_names[-1]
            tv, tr, tc = (mesh.allgather(t, ax) for t in (tv, tr, tc))
        vals = tv.cpu().numpy()
        ii_all = tr.cpu().numpy().astype(np.int64)
        jj_all = tc.cpu().numpy().astype(np.int64)
        real = (ii_all < l) & (jj_all < l)
        vals, ii_all, jj_all = vals[real], ii_all[real], jj_all[real]
        sel = np.argsort(-np.abs(vals), kind="stable")[:k_cap]
        top_idx = ii_all[sel] * np.int64(l) + jj_all[sel]
        top_beta = vals[sel].astype(np.float64)
        sel_idx = np.sort(top_idx[np.abs(top_beta) > eps])
        return _materialize_pairs(f, X, sel_idx, l, eps, entries, populations, loci_alleles)

    # Generic (arbitrary f) path: running top-k merge across blocks (flat
    # index = i * l + j). Each block's candidate top-k is selected on the
    # device, so only k (value, index) pairs come back per block.
    Xj = torch.as_tensor(X.astype(np.float32), device=dev)
    okj = torch.as_tensor(ok, device=dev)
    top_idx = np.zeros(0, dtype=np.int64)
    top_beta = np.zeros(0, dtype=np.float64)
    for start in range(0, l, block):
        bi = min(block, l - start)
        k = int(min(k_cap, bi * l))
        vals, idx = _generic_block_topk(Xj[:, start : start + bi], Xj, ym, okj[start : start + bi],
                                        okj, start, f, commutative, k)
        cand_idx = np.int64(start) * l + idx.cpu().numpy().astype(np.int64)
        merged_idx = np.concatenate([top_idx, cand_idx])
        merged_beta = np.concatenate([top_beta, vals.double().cpu().numpy()])
        sel = np.argsort(-np.abs(merged_beta), kind="stable")[:k_cap]
        top_idx, top_beta = merged_idx[sel], merged_beta[sel]

    sel_idx = np.sort(top_idx[np.abs(top_beta) > eps])  # reference sorts selected flat indices (:429)
    return _materialize_pairs(f, X, sel_idx, l, eps, entries, populations, loci_alleles)


def _materialize_pairs(f, X, sel_idx, l, eps, entries, populations, loci_alleles) -> Genomes:
    ii = sel_idx // l
    jj = sel_idx % l
    T = np.asarray(f(X[:, ii], X[:, jj]), dtype=np.float64)
    T = _snap(T, eps)
    fname = registry_name(f)
    names = np.asarray(
        [f"{fname}({loci_alleles[a]},{loci_alleles[b]})" for a, b in zip(ii, jj)], dtype=object
    )
    out = Genomes(entries=entries, populations=populations, loci_alleles=names, allele_frequencies=T)
    if not out.checkdims():
        raise RuntimeError(f"error transforming locus pairs with {fname!r}")
    return out


def epistasisfeatures(
    genomes: Genomes,
    phenomes: Phenomes,
    idx_trait: int = 0,
    idx_entries: Optional[Sequence[int]] = None,
    idx_loci_alleles: Optional[Sequence[int]] = None,
    transformations1: Sequence[Callable] = UNARY_DEFAULTS,
    transformations2: Sequence[Callable] = BINARY_DEFAULTS,
    n_new_features_per_transformation: int = 1_000,
    n_reps: int = 3,
    verbose: bool = False,
    device="cuda",
) -> Genomes:
    """Grow a genomes struct with engineered epistasis features
    (reference src/transformation.jl:540-668), every transform's scan on
    `device`."""
    if not genomes.checkdims():
        raise ValueError("the Genomes struct is corrupted")
    if not phenomes.checkdims():
        raise ValueError("the Phenomes struct is corrupted")
    if not np.array_equal(genomes.entries, phenomes.entries):
        raise ValueError("genomes and phenomes must be merged to have consistent entries")
    g = genomes.slice(idx_entries=idx_entries, idx_loci_alleles=idx_loci_alleles)
    ph = phenomes.slice(idx_entries=idx_entries, idx_traits=[idx_trait])
    for _rep in range(n_reps):
        for f in list(transformations1) + list(transformations2):
            unary = f in tuple(transformations1)
            tf = transform1 if unary else transform2
            new = tf(
                f, g, ph,
                idx_trait=0,
                n_new_features_per_transformation=n_new_features_per_transformation,
                device=device,
            )
            existing = set(g.loci_alleles.tolist())
            fresh = [i for i, nm in enumerate(new.loci_alleles.tolist()) if nm not in existing]
            if fresh:
                g = Genomes(
                    entries=g.entries,
                    populations=g.populations,
                    loci_alleles=np.concatenate([g.loci_alleles, new.loci_alleles[fresh]]),
                    allele_frequencies=np.concatenate(
                        [g.allele_frequencies, new.allele_frequencies[:, fresh]], axis=1
                    ),
                )
            lo = g.allele_frequencies.min()
            hi = g.allele_frequencies.max()
            if lo < 0.0 or hi > 1.0 + 1e-12:
                raise ValueError(
                    f"the function {registry_name(f)!r} generates values outside [0, 1] "
                    f"(observed range [{lo}, {hi}])"
                )
    if not g.checkdims():
        raise RuntimeError("error generating new features")
    return g


# ---------------------------------------------------------------------------
# Feature reconstitution: parse name strings -> expression trees -> vectorized
# ---------------------------------------------------------------------------


def parse_feature_name(name: str, known_funcs=FUNCTION_REGISTRY):
    """Parse 'f(a,g(b,c))' into ('f', [child...]); leaves are locus names."""
    name = name.strip()
    paren = name.find("(")
    if paren > 0 and name.endswith(")") and name[:paren] in known_funcs:
        fname = name[:paren]
        inner = name[paren + 1 : -1]
        args, depth, start = [], 0, 0
        for i, ch in enumerate(inner):
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
            elif ch == "," and depth == 0:
                args.append(inner[start:i])
                start = i + 1
        args.append(inner[start:])
        return (fname, [parse_feature_name(a, known_funcs) for a in args])
    return name  # leaf locus


def _eval_tree(tree, genomes: Genomes, cache: dict) -> np.ndarray:
    if isinstance(tree, str):
        idx = genomes.locus_indices([tree])[0]
        return genomes.allele_frequencies[:, idx]
    fname, children = tree
    key = repr(tree)
    if key in cache:
        return cache[key]
    f = FUNCTION_REGISTRY[fname]
    vals = [_eval_tree(c, genomes, cache) for c in children]
    # Reapply the ε shift the transforms applied to their inputs.
    vals = [v + _EPS for v in vals]
    # Snap to {0, 1} exactly as the stored column was at construction time
    # (transform1/2 snap before the column is reused by later rounds), so the
    # round-trip is bit-exact.
    out = _snap(np.asarray(f(*vals), dtype=np.float64), _EPS)
    cache[key] = out
    return out


def reconstitutefeatures(
    genomes: Genomes,
    feature_names: Sequence[str],
    verbose: bool = False,
) -> Genomes:
    """Re-materialize engineered features on a new genomes struct from their
    name strings (reference src/transformation.jl:730-778, minus the eval),
    on the host in float64."""
    if not genomes.checkdims():
        raise ValueError("the Genomes struct is corrupted")
    n = genomes.n
    cols = np.zeros((n, len(feature_names)))
    cache: dict = {}
    # Snapping happens inside _eval_tree (function outputs only): raw locus
    # columns pass through untouched, exactly as epistasisfeatures leaves them.
    for j, name in enumerate(feature_names):
        tree = parse_feature_name(str(name))
        cols[:, j] = _eval_tree(tree, genomes, cache)
    out = Genomes(
        entries=genomes.entries,
        populations=genomes.populations,
        loci_alleles=np.asarray(list(feature_names), dtype=object),
        allele_frequencies=cols,
    )
    if not out.checkdims():
        raise RuntimeError("error reconstituting features")
    return out
