"""K1/K2/K3 CUDA kernels against their plain versions, and the paths that
launch them (GBLUP, GWAS, the fold chains, the out-of-core GRM with its
pinned-buffer uploads and the pieces CG), on the card only.

The kernels have no CPU mode, so these tests carry the `cuda` marker and skip
where there is no CUDA device. This file imports neither jax nor the JAX
package, so it also runs where only the port is installed:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -m cuda -q
"""

import pytest
import torch

from genomicbreedingmodels_tpu_torch.kernels import _build, gibbs_group, gram_tri


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions must not use TF32
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,p", [(64, 512), (129, 257), (1000, 4099), (4352, 24576)])
def test_kernels_match_plain_on_card(cuda_device, n, p):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    D = torch.randint(0, 3, (n, p), dtype=torch.int8, device=cuda_device, generator=g)
    before = dict(gram_tri.LAUNCHES)
    K = gram_tri.gram_tri_int8(D)
    assert torch.equal(K, gram_tri.gram_tri_int8_plain(D))
    assert not torch.triu(K, 1).any()
    for dt in (torch.float32, torch.bfloat16):
        X = torch.rand((n, p), device=cuda_device, generator=g).to(dt)
        K, R = gram_tri.gram_tri_float(X), gram_tri.gram_tri_float_plain(X)
        assert float((K - R).abs().max()) <= 1e-5 * float(R.abs().max())
        assert not torch.triu(K, 1).any()
    assert gram_tri.LAUNCHES["gram_tri_int8"] == before["gram_tri_int8"] + 1
    assert gram_tri.LAUNCHES["gram_tri_float"] == before["gram_tri_float"] + 2
    assert ("int8", n, p) in _build.LAUNCH_SHAPES["gram_tri_int8"]
    assert {("float32", n, p), ("bfloat16", n, p)} <= _build.LAUNCH_SHAPES["gram_tri_float"]


def _check_gram_kernels(D, X_list):
    """K1 bit-equal to its plain version, K2 within 1e-5·max|G| of float64,
    strict upper triangle zero for both."""
    K = gram_tri.gram_tri_int8(D)
    assert torch.equal(K, gram_tri.gram_tri_int8_plain(D))
    assert not torch.triu(K, 1).any()
    for X in X_list:
        K, R = gram_tri.gram_tri_float(X), gram_tri.gram_tri_float_plain(X)
        assert float((K - R).abs().max()) <= 1e-5 * float(R.abs().max()), X.dtype
        assert not torch.triu(K, 1).any()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 129, 300])
@pytest.mark.parametrize("p", [1, 15, 257, 4099])
def test_gram_kernels_ragged_on_card(cuda_device, n, p):
    """Ragged n and p: TMA zero-fills past the panel, the wrapper pads p to a
    16-byte row, and tiles crossing the diagonal write only col <= row."""
    g = torch.Generator(device=cuda_device).manual_seed(n * 10_000 + p)
    D = torch.randint(0, 3, (n, p), dtype=torch.int8, device=cuda_device, generator=g)
    X = torch.rand((n, p), device=cuda_device, generator=g)
    _check_gram_kernels(D, [X, X.to(torch.bfloat16)])


@pytest.mark.cuda
def test_gram_int8_marker_splits_on_card(cuda_device):
    """Few tiles over many markers: K1 splits each tile's markers eight ways
    and adds the partial sums with int32 atomics, still bit-equal."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    D = torch.randint(0, 3, (300, 65_536), dtype=torch.int8, device=cuda_device, generator=g)
    _check_gram_kernels(D, [])


@pytest.mark.cuda
def test_gram_kernels_misaligned_base_on_card(cuda_device):
    """A contiguous view whose base is not 16-byte aligned is copied for TMA."""
    n, p = 200, 512
    g = torch.Generator(device=cuda_device).manual_seed(3)
    flat = torch.randint(0, 3, (n * p + 1,), dtype=torch.int8, device=cuda_device, generator=g)
    D = flat[1:].view(n, p)
    assert D.is_contiguous() and D.data_ptr() % 16
    xs = []
    for dt in (torch.float32, torch.bfloat16):
        flat = torch.rand((n * p + 1,), device=cuda_device, generator=g).to(dt)
        xs.append(flat[1:].view(n, p))
        assert xs[-1].data_ptr() % 16
    _check_gram_kernels(D, xs)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_gram_float_at_size_on_card(cuda_device, dt):
    """K2 at 2048 x 32768, the timed shape: 3xTF32 (f32) and bf16 wgmma with
    256-marker folds stay within 1e-5·max|G| of float64."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    X = torch.rand((2048, 32768), device=cuda_device, generator=g).to(dt)
    K, R = gram_tri.gram_tri_float(X), gram_tri.gram_tri_float_plain(X)
    assert float((K - R).abs().max()) <= 1e-5 * float(R.abs().max())
    assert not torch.triu(K, 1).any()


@pytest.mark.cuda
@pytest.mark.parametrize("n,p", [(4096, 65536), (8192, 4096), (8193, 4099), (2048, 4099), (1844, 4099),
                                 (300, 4099)])
def test_gram_bf16_schedule_by_shape_on_card(cuda_device, n, p):
    """K2 on bf16 in the schedule the shape rule picks (2x2 clusters from
    n = 1921 on 132 SMs, one CTA per tile below), ragged n and p included:
    within 1e-5·max|G| of float64, strict upper triangle zero, and the
    traced counter names the schedule that ran."""
    from genomicbreedingmodels_tpu_torch.utils import logging as tr

    g = torch.Generator(device=cuda_device).manual_seed(n + p)
    X = torch.rand((n, p), device=cuda_device, generator=g).to(torch.bfloat16)
    tr.reset()
    with tr.tracing():
        K = gram_tri.gram_tri_float(X)
    counters = tr.collect()["counters"]
    tr.reset()
    R = gram_tri.gram_tri_float_plain(X)
    assert float((K - R).abs().max()) <= 1e-5 * float(R.abs().max())
    assert not torch.triu(K, 1).any()
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    quad = gram_tri.bf16_quad(n, sms)
    assert counters == {"gbm.grm.k2.clustered" if quad else "gbm.grm.k2.single": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("quad", [0, 1], ids=["single", "clustered"])
def test_gram_bf16_both_schedules_at_size_on_card(cuda_device, quad):
    """bf16 K2 at 2048 x 32768 in each schedule, whichever the rule picks:
    both within 1e-5·max|G| of float64 with the strict upper triangle zero,
    and the wrapper's Gram is the bits of the schedule the rule names."""
    n, p = 2048, 32768
    g = torch.Generator(device=cuda_device).manual_seed(6)
    X = torch.rand((n, p), device=cuda_device, generator=g).to(torch.bfloat16)
    K = torch.zeros((n, n), dtype=torch.float32, device=cuda_device)
    _build.launch("gbm_gram_tri_bf16_schedule", X.data_ptr(), K.data_ptr(), n, p, quad,
                  torch.cuda.current_stream(cuda_device).cuda_stream)
    R = gram_tri.gram_tri_float_plain(X)
    assert float((K - R).abs().max()) <= 1e-5 * float(R.abs().max())
    assert not torch.triu(K, 1).any()
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    if gram_tri.bf16_quad(n, sms) == bool(quad):
        assert torch.equal(gram_tri.gram_tri_float(X), K)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_bad_inputs_on_card(cuda_device):
    with pytest.raises(ValueError, match="contiguous"):
        gram_tri.gram_tri_int8(torch.zeros(8, 4, dtype=torch.int8, device=cuda_device).T)
    with pytest.raises(TypeError):
        gram_tri.gram_tri_float(torch.zeros(4, 8, dtype=torch.float64, device=cuda_device))
    empty = gram_tri.gram_tri_int8(torch.zeros(0, 5, dtype=torch.int8, device=cuda_device))
    assert empty.shape == (0, 0)


def _gibbs_block(dev, bs, K, n=1000, n_invalid=0, seed=0):
    """One chain-like block on the card: Cb and u = X_bᵀr from a random
    centered dosage panel, sparse effects, and the shared noise."""
    g = torch.Generator(device=dev).manual_seed(seed)
    X = torch.randint(0, 3, (n, bs), device=dev, generator=g).float() / 2
    X -= X.mean(0)
    val = torch.ones(bs, device=dev)
    if n_invalid:
        val[-n_invalid:] = 0.0
        X[:, -n_invalid:] = 0.0
    b = torch.randn(bs, device=dev, generator=g) * (torch.rand(bs, device=dev, generator=g) < 0.1) * val
    r = torch.randn(n, device=dev, generator=g)
    gum = -torch.log(-torch.log(torch.rand((bs // K, 1 << K), device=dev, generator=g)
                                .clamp_(1e-12, 1 - 1e-7)))
    return (X.T @ X, X.T @ r, b, torch.full((bs,), 0.02, device=dev), val,
            torch.randn(bs, device=dev, generator=g), gum,
            torch.tensor(0.9, device=dev), torch.tensor(0.1, device=dev))


def _assert_agree(out, ref, n_invalid=0):
    """K3's (delta, b_new, incl) against the plain version's on the same
    inputs and noise: identical selections, draws within 1e-4·max(1, max|b|),
    invalid markers neither drawn nor included. The two sum in other orders
    (the plain version carries v/σ²ₑ, the kernel u − cdelta, with fused
    multiply-adds), and the running correlation carries that rounding through
    all bs/K groups."""
    (d, b_new, incl), (d_p, b_p, incl_p) = out, ref
    assert torch.equal(incl, incl_p)
    tol = 1e-4 * max(1.0, float(b_p.abs().max()))
    assert float((b_new - b_p).abs().max()) <= tol
    assert float((d - d_p).abs().max()) <= tol
    if n_invalid:
        assert not b_new[-n_invalid:].any() and not incl[-n_invalid:].any()


def _check_gibbs_group(args, K, n_invalid=0):
    """One K3 launch, counted once (the plain version counts none), against
    the plain version."""
    before = gibbs_group.LAUNCHES["gibbs_group"]
    out = gibbs_group.grouped_block_update(*args, K=K)
    assert gibbs_group.LAUNCHES["gibbs_group"] == before + 1
    ref = gibbs_group.grouped_block_update_plain(*args, K=K)
    torch.cuda.synchronize()
    assert gibbs_group.LAUNCHES["gibbs_group"] == before + 1
    _assert_agree(out, ref, n_invalid)


@pytest.mark.cuda
@pytest.mark.parametrize("bs,K", [(64, 8), (66, 6), (600, 6), (600, 8)])  # 64 at K=6: 66, as the chain rounds
def test_gibbs_group_matches_plain_on_card(cuda_device, bs, K):
    """K3 against its plain version at the chain's block sizes, the last 3
    markers invalid."""
    _check_gibbs_group(_gibbs_block(cuda_device, bs, K, n_invalid=3), K, n_invalid=3)


@pytest.mark.cuda
@pytest.mark.parametrize("K", range(1, 9))
def test_gibbs_group_every_k_on_card(cuda_device, K):
    """K = 1…8 at a small block (5 groups, the last marker invalid): lanes
    that hold no pattern (K ≤ 4), one pattern per lane (K = 5) and 2, 4 and 8
    patterns per lane (K = 6, 7, 8)."""
    _check_gibbs_group(_gibbs_block(cuda_device, 5 * K, K, n_invalid=1, seed=K), K, n_invalid=1)


@pytest.mark.cuda
@pytest.mark.parametrize("bs,n_invalid", [(1024, 5), (gibbs_group.MAX_BS, 7)])
def test_gibbs_group_large_blocks_on_card(cuda_device, bs, n_invalid):
    """bs=1024 at K=8, the largest `auto` block, stages every quad of the Cb
    rows in shared memory; bs=MAX_BS stages the first quads and reads the
    rest from L2, with the same arithmetic."""
    lay = gibbs_group.k3_layout(bs, 8)
    assert (lay.staged_quads == lay.quads) == (bs == 1024)
    _check_gibbs_group(_gibbs_block(cuda_device, bs, 8, n_invalid=n_invalid, seed=bs), 8, n_invalid)


@pytest.mark.cuda
def test_gibbs_group_reused_workspace_on_card(cuda_device):
    """Two launches in a row with different inputs on one workspace, each held
    against the plain version: a flag left by the first launch must not pass
    for the second's (the epoch differs), or the second would score the
    first's tables."""
    first = _gibbs_block(cuda_device, 600, 6, n_invalid=2, seed=11)
    second = _gibbs_block(cuda_device, 600, 6, n_invalid=2, seed=12)
    out1 = gibbs_group.grouped_block_update(*first, K=6)
    out2 = gibbs_group.grouped_block_update(*second, K=6)
    _assert_agree(out1, gibbs_group.grouped_block_update_plain(*first, K=6), 2)
    _assert_agree(out2, gibbs_group.grouped_block_update_plain(*second, K=6), 2)
    assert not torch.equal(out1[1], out2[1])


@pytest.mark.cuda
def test_gibbs_group_side_stream_on_card(cuda_device):
    """A launch on a stream other than the default one, with its own workspace."""
    args = _gibbs_block(cuda_device, 258, 6, n_invalid=5, seed=13)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = gibbs_group.grouped_block_update(*args, K=6)
    torch.cuda.current_stream().wait_stream(side)
    assert (args[0].device, side.cuda_stream) in gibbs_group._WORKSPACES
    _assert_agree(out, gibbs_group.grouped_block_update_plain(*args, K=6), 5)


@pytest.mark.cuda
def test_gibbs_group_two_threads_one_stream_on_card(cuda_device):
    """Two host threads launch K3 on the one default stream, 200 launches
    each on their own inputs: every result equals its plain version, and the
    count went up by exactly 400 (the workspace epoch and the count are
    taken under one lock; with a shared epoch a launch could read the other
    thread's tables as ready)."""
    import threading

    blocks = [_gibbs_block(cuda_device, 258, 6, n_invalid=2, seed=20 + t) for t in range(2)]
    refs = [gibbs_group.grouped_block_update_plain(*b, K=6) for b in blocks]
    torch.cuda.synchronize()
    before = gibbs_group.LAUNCHES["gibbs_group"]
    outs = [[], []]

    def worker(t):
        for _ in range(200):
            outs[t].append(gibbs_group.grouped_block_update(*blocks[t], K=6))

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads)
    torch.cuda.synchronize()
    assert gibbs_group.LAUNCHES["gibbs_group"] == before + 400
    for t in range(2):
        assert len(outs[t]) == 200
        for out in outs[t]:
            _assert_agree(out, refs[t], 2)


def _fold_blocks(dev, F, bs, K, n_invalid, seed=30):
    """F independent blocks stacked on a fold axis, as the fold chain hands
    them to K3: b and s2 are (F, bs) slices of (F, 3·bs) states (fold stride
    3·bs), the rest (F, ...) contiguous; σ²ₑ and π differ per fold."""
    blocks = [_gibbs_block(dev, bs, K, n=400, n_invalid=n_invalid, seed=seed + f) for f in range(F)]
    Cb, u, b, s2, val, eta, gum = (torch.stack([blk[i] for blk in blocks]) for i in range(7))
    state_b = torch.zeros(F, 3 * bs, device=dev)
    state_b[:, bs : 2 * bs] = b
    state_s2 = torch.ones(F, 3 * bs, device=dev)
    state_s2[:, bs : 2 * bs] = s2 * torch.linspace(0.5, 2.0, F, device=dev)[:, None]
    sig = torch.linspace(0.6, 1.4, F, device=dev)
    pi = torch.linspace(0.05, 0.4, F, device=dev)
    return (Cb, u, state_b[:, bs : 2 * bs], state_s2[:, bs : 2 * bs], val[0], eta, gum, sig, pi)


@pytest.mark.cuda
@pytest.mark.parametrize("F", [1, 5, 15, 200])
def test_gibbs_group_fold_batched_matches_single_launches_on_card(cuda_device, F):
    """One fold-batched K3 call against F single launches (bit-equal: each
    fold runs the same code on the same numbers) and against the plain
    version, at the cv cell's bs=258, K=6. F = 200 exceeds the 132 SMs: the
    wrapper splits it into launches of at most half the SMs, and the call
    must finish (a launch whose scan CTAs starved their builders would spin
    until its waits trap), so it runs under a timeout."""
    import threading

    bs, K = 258, 6
    args = _fold_blocks(cuda_device, F, bs, K, n_invalid=5)
    cap = gibbs_group.folds_per_launch(torch.cuda.get_device_properties(cuda_device).multi_processor_count)
    torch.cuda.synchronize()
    before = gibbs_group.LAUNCHES["gibbs_group"]
    out = []

    def run():
        out.append(gibbs_group.grouped_block_update(*args, K=K))
        torch.cuda.synchronize()

    th = threading.Thread(target=run)
    th.start()
    th.join(timeout=120)
    assert not th.is_alive(), "the fold-batched K3 launch did not finish"
    assert out, "the fold-batched K3 launch raised"
    assert gibbs_group.LAUNCHES["gibbs_group"] == before + -(-F // cap)
    d, b_new, incl = out[0]
    assert d.shape == (F, bs)
    ref = gibbs_group.grouped_block_update_plain(*args, K=K)
    for f in range(F):
        one = gibbs_group.grouped_block_update(args[0][f], args[1][f], args[2][f].contiguous(),
                                               args[3][f].contiguous(), args[4], args[5][f],
                                               args[6][f], args[7][f], args[8][f], K=K)
        for x, r in zip((d, b_new, incl), one):
            assert torch.equal(x[f], r), f
        _assert_agree((d[f], b_new[f], incl[f]), tuple(r[f] for r in ref), 5)


@pytest.mark.cuda
def test_gibbs_group_f1_fold_launch_is_the_single_launch_on_card(cuda_device):
    """F = 1 through the fold axis is the single-chain launch, bit for bit."""
    args = _gibbs_block(cuda_device, 600, 6, n_invalid=3, seed=40)
    one = gibbs_group.grouped_block_update(*args, K=6)
    folded = gibbs_group.grouped_block_update(*(a[None] for a in args[:4]), args[4],
                                              *(a[None] for a in args[5:]), K=6)
    for x, r in zip(folded, one):
        assert torch.equal(x[0], r)


@pytest.mark.cuda
def test_bayesc_fold_chains_on_card_near_closed_form(cuda_device):
    """BayesC fold chains on the card (K3 once per block and sweep for all 3
    folds) with pinned variances, each fold's GEBVs against its training
    rows' closed-form ridge posterior mean: cor >= 0.99, the bound of
    tests/test_torch_bayesian.py's pinned BayesC chain (its spike-and-slab
    mean is not the ridge mean)."""
    import numpy as np

    import genomicbreedingmodels_tpu_torch as gbm

    rng = np.random.default_rng(13)
    n, p, sig_e2, sig_b2 = 90, 40, 0.5, 0.05
    X = rng.uniform(size=(n, p))
    idx = rng.choice(p, 10, replace=False)
    g = X[:, idx] @ rng.normal(size=10)
    y = np.sqrt(0.6) * (g - g.mean()) / g.std() + np.sqrt(0.4) * rng.normal(size=n)
    labels = rng.integers(0, 3, size=n)
    masks = np.stack([labels != f for f in range(3)]).astype(np.float32)
    before = gibbs_group.LAUNCHES["gibbs_group"]
    mu, b = gbm.gibbs_cv_folds(X, y, masks, model="BayesC", n_iter=1200, n_burnin=200, seed=17,
                               fix_sigma_e2=sig_e2, fix_sigma_b2=sig_b2, device="cuda")
    assert gibbs_group.LAUNCHES["gibbs_group"] - before == 1200  # one block, one launch a sweep
    for f in range(3):
        m = masks[f] > 0
        Z = X[m] - X[m].mean(0)
        b_star = np.linalg.solve(Z.T @ Z / sig_e2 + np.eye(p) / sig_b2, Z.T @ (y[m] - y[m].mean()) / sig_e2)
        yhat = (y[m].mean() - X[m].mean(0) @ b_star) + X @ b_star
        assert np.corrcoef(mu[f] + X @ b[f], yhat)[0, 1] >= 0.99, f


@pytest.mark.cuda
def test_gibbs_group_wrapper_rejects_bad_inputs_on_card(cuda_device):
    args = list(_gibbs_block(cuda_device, 60, 6))
    with pytest.raises(ValueError, match="Cb on"):
        gibbs_group.grouped_block_update(*args[:7], args[7].cpu(), args[8], K=6)
    with pytest.raises(ValueError, match="K <= 8"):
        gibbs_group.grouped_block_update(*args, K=10)


@pytest.mark.cuda
def test_gblup_training_fold_on_card_matches_cpu(cuda_device):
    """gblup on a 162-entry training fold of a 256x2048 panel called to
    {0, 1/2, 1} (K1 for the GRM): REML's σ² within 1e-3 relative and the
    validation y_pred within 1e-3·std(y) of device="cpu" (1.2e-4 measured
    on an H100). The card's eigendecomposition runs in f64; in f32 this
    fold's σ²ₑ moved by 25 % and y_pred by 0.06·std(y)."""
    import numpy as np

    import genomicbreedingmodels_tpu_torch as gbm
    from genomicbreedingmodels_tpu_torch.cv import harness

    g = gbm.simulate_genomes(n=256, l=2048, seed=5)
    trials, _ = gbm.simulate_trials(g, f_add_dom_epi=np.array([[0.4, 0.05, 0.05]]), seed=5)
    ph = gbm.extract_phenomes(trials)
    g = gbm.Genomes(entries=g.entries, populations=g.populations, loci_alleles=g.loci_alleles,
                    allele_frequencies=np.rint(2.0 * g.allele_frequencies) / 2.0)
    job = harness._cvbulk_jobs(g, ph, ["gblup"], 1, 3, 7)[0][1]
    assert len(job["idx_training"]) == 162
    fits = {d: gbm.gblup(g, ph, idx_entries=job["idx_training"], device=d) for d in ("cuda", "cpu")}
    for k in ("sigma2_e", "sigma2_u"):
        assert abs(fits["cuda"].extras[k] - fits["cpu"].extras[k]) <= 1e-3 * abs(fits["cpu"].extras[k]), k
    preds = {d: gbm.predict(f, g, job["idx_validation"], device=d) for d, f in fits.items()}
    assert np.abs(preds["cuda"] - preds["cpu"]).max() <= 1e-3 * np.std(ph.phenotypes[:, 0])


def _qtl_panel():
    """tests/test_gwas.py's `gwas_data` at 256x2048: tetraploid calls, one
    h² = 0.5 trait of 5 QTL."""
    import numpy as np

    import genomicbreedingmodels_tpu_torch as gbm

    g = gbm.simulate_genomes(n=256, l=2048, seed=42)
    g = gbm.Genomes(entries=g.entries, populations=g.populations, loci_alleles=g.loci_alleles,
                    allele_frequencies=np.round(g.allele_frequencies * 4) / 4)
    pv = np.zeros((9, 1))
    pv[0, 0] = 0.5
    tr, _ = gbm.simulate_trials(g, f_add_dom_epi=np.array([[0.05, 0.0, 0.0]]),
                                proportion_of_variance=pv, n_qtl=5, seed=42)
    return gbm, g, gbm.extract_phenomes(tr)


@pytest.mark.cuda
def test_gwas_on_card_matches_cpu(cuda_device):
    """gwasols, gwaslmm and gwasreml on the card against device="cpu": the
    same loci, statistic cor >= 0.999, one argmax marker across all six
    fits, gwaslmm's σ² within 1e-3 relative."""
    import numpy as np

    gbm, g, ph = _qtl_panel()
    fits = {d: {f: getattr(gbm, f)(g, ph, device=d) for f in ("gwasols", "gwaslmm", "gwasreml")}
            for d in ("cuda", "cpu")}
    tops = set()
    for name, a in fits["cuda"].items():
        b = fits["cpu"][name]
        assert np.array_equal(a.b_hat_labels, b.b_hat_labels)
        assert np.all(np.isfinite(a.b_hat)) and np.corrcoef(a.b_hat, b.b_hat)[0, 1] >= 0.999, name
        tops |= {int(np.argmax(np.abs(a.b_hat))), int(np.argmax(np.abs(b.b_hat)))}
    assert len(tops) == 1
    for k in ("sigma2_e", "sigma2_u"):
        a, b = fits["cuda"]["gwaslmm"].extras[k], fits["cpu"]["gwaslmm"].extras[k]
        assert abs(a - b) <= 1e-3 * abs(b), k


@pytest.mark.cuda
def test_eigh_device_runs_f64_on_card(cuda_device):
    """`_eigh_device` on a card f32 GRM returns f32 computed in f64: its
    spectrum within 1e-6·max|K| of the CPU's f64 one (the card's own f32
    eigh lies ~6e-4·max|K| away on fold GRMs), its basis orthonormal to
    f32 rounding."""
    import numpy as np

    from genomicbreedingmodels_tpu_torch.ops.linalg import _eigh_device

    gbm, g, _ = _qtl_panel()
    K = gbm.grm_simple(g, device="cuda").genomic_relationship_matrix
    s, U = _eigh_device(K)
    assert s.dtype == U.dtype == torch.float32 and s.is_cuda
    Kh = K.double().cpu()
    ref = np.maximum(torch.linalg.eigh(0.5 * (Kh + Kh.T))[0].numpy(), 0.0)
    scale = float(Kh.abs().max())
    assert np.abs(s.double().cpu().numpy() - ref).max() <= 1e-6 * scale
    eye = U.T @ U
    assert float((eye - torch.eye(len(s), device="cuda")).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_ols_folds_on_card_match_f64_lstsq(cuda_device):
    """`cvbulk`'s OLS on chip_smoke.py phase 10 (a)'s 256x2048 called panel,
    1x3 folds: the card's validation y_pred within 1e-4·std(y) of an f64
    numpy min-norm lstsq per fold (the dual solve eigendecomposes through
    `_eigh_device`, f64 on the card), and within 1e-3·std(y) of
    device="cpu", whose f32 eigh alone moves y_pred by up to ~7e-4·std(y)."""
    import numpy as np

    import genomicbreedingmodels_tpu_torch as gbm

    g = gbm.simulate_genomes(n=256, l=2048, seed=5)
    trials, _ = gbm.simulate_trials(g, f_add_dom_epi=np.array([[0.4, 0.05, 0.05]]), seed=5)
    ph = gbm.extract_phenomes(trials)
    g = gbm.Genomes(entries=g.entries, populations=g.populations, loci_alleles=g.loci_alleles,
                    allele_frequencies=np.rint(2.0 * g.allele_frequencies) / 2.0)
    runs = {d: gbm.cvbulk(g, ph, models=["ols"], n_replications=1, n_folds=3, seed=7, device=d)[0]
            for d in ("cuda", "cpu")}
    y = ph.phenotypes[:, 0]
    sd = np.std(y)
    X = np.hstack([np.ones((g.n, 1)), g.allele_frequencies])
    for a, b in zip(runs["cuda"], runs["cpu"]):
        assert np.array_equal(a.validation_entries, b.validation_entries)
        va = g.entry_indices(a.validation_entries.tolist())
        tr = np.setdiff1d(np.arange(g.n), va)
        ref = X[va] @ np.linalg.lstsq(X[tr], y[tr], rcond=None)[0]
        assert np.abs(a.y_pred - ref).max() <= 1e-4 * sd
        assert np.abs(a.y_pred - b.y_pred).max() <= 1e-3 * sd


def _write_bed_trio(prefix, n, p, seed, missing=0.0):
    """A .bed trio of {0, ½, 1} frequencies (a `missing` share of NaN calls)
    written by the port's `write_bed`; returns the frequencies."""
    import numpy as np

    from genomicbreedingmodels_tpu_torch import Genomes, write_bed

    rng = np.random.default_rng(seed)
    F = rng.choice([0.0, 0.5, 1.0], size=(n, p))
    F[rng.random((n, p)) < missing] = np.nan
    write_bed(Genomes(entries=np.array([f"e{i}" for i in range(n)], dtype=object),
                      populations=np.array(["pop1"] * n, dtype=object),
                      loci_alleles=np.array([f"chr1\t{j + 1}\tA|T\tA" for j in range(p)], dtype=object),
                      allele_frequencies=F), prefix)
    return F


@pytest.mark.cuda
@pytest.mark.parametrize("missing", [0.0, 0.01])
def test_grm_from_bed_on_card_matches_cpu(cuda_device, tmp_path, missing):
    """Complete shards through K1 (SNP-major, transposed on the card), shards
    with missing calls through K2: within 1e-5·max|K| of device="cpu"."""
    from genomicbreedingmodels_tpu_torch.streaming import grm_from_bed

    _write_bed_trio(tmp_path / "p", 300, 1001, seed=1, missing=missing)
    before = dict(gram_tri.LAUNCHES)
    K = grm_from_bed(tmp_path / "p", block_cols=250, device=cuda_device).cpu()
    R = grm_from_bed(tmp_path / "p", block_cols=250, device="cpu")
    assert float((K - R).abs().max()) <= 1e-5 * float(R.abs().max())
    launched = {k: gram_tri.LAUNCHES[k] - before[k] for k in before}
    if missing:
        assert launched["gram_tri_float"] > 0
    else:
        assert launched == {"gram_tri_int8": 5, "gram_tri_float": 0, "gibbs_group": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [13, 60, 301])
def test_unpack_bed_payload_on_card_bit_exact(cuda_device, tmp_path, n):
    """The card's unpack equals the host int8 decode (missing as 0), with the
    same missing count; n % 4 != 0 checks the last byte's padding."""
    import numpy as np

    from genomicbreedingmodels_tpu_torch.ops.pieces import unpack_bed_payload
    from genomicbreedingmodels_tpu_torch.streaming import BedShardStreamer

    F = _write_bed_trio(tmp_path / "p", n, 77, seed=2, missing=0.02)
    _, _, payload = next(iter(BedShardStreamer(tmp_path / "p", block_cols=77).iter_payload()))
    D, miss = unpack_bed_payload(torch.from_numpy(payload).to(cuda_device), n)
    expect = np.nan_to_num(F.T * 2, nan=0.0).astype(np.int8)
    assert torch.equal(D.cpu(), torch.from_numpy(expect))
    assert int(miss) == int(np.isnan(F).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("cols", [31, 250, 1001])
def test_gram_dosage_snp_major_on_card_bit_equal(cuda_device, cols):
    """A shard width that is not a multiple of 16: one transposing copy into a
    padded buffer, K1 bit-equal to its plain version on the entry-major shard."""
    from genomicbreedingmodels_tpu_torch.ops.grm import gram_dosage, gram_tri_snp_major

    g = torch.Generator(device=cuda_device).manual_seed(3)
    F = torch.randint(0, 3, (cols, 517), dtype=torch.int8, device=cuda_device, generator=g)
    L = gram_tri_snp_major(F, 2, device=cuda_device)
    assert torch.equal(L, gram_tri.gram_tri_int8_plain(F.T.contiguous(), 2))
    assert ("int8", 517, -(-cols // 16) * 16) in _build.LAUNCH_SHAPES["gram_tri_int8"]
    from genomicbreedingmodels_tpu_torch.ops.grm import gram_dosage_snp_major

    assert torch.equal(gram_dosage_snp_major(F, device=cuda_device),
                       gram_dosage(F.T.contiguous(), device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("ahead", ["1", "0"])
def test_pinned_ring_reuses_buffers_on_card(cuda_device, monkeypatch, ahead):
    """More shards than pinned buffers, each consumed by a kernel on the
    caller's stream while later copies run: every shard arrives intact after
    its buffer was reused (a missing stream wait or an early refill would
    show as a wrong sum), and the inline mode yields the same."""
    import numpy as np

    from genomicbreedingmodels_tpu_torch.streaming import _iter_device_ahead

    monkeypatch.setenv("GBM_STREAM_H2D_AHEAD", ahead)
    rng = np.random.default_rng(4)
    shards = [(i, i + 1, rng.integers(0, 255, size=(2048, 4096), dtype=np.uint8)) for i in range(9)]
    sums, kept = [], []
    for k, (a, b, t) in enumerate(_iter_device_ahead(iter(shards), device=cuda_device)):
        assert (a, b) == shards[k][:2] and t.is_cuda
        sums.append(t.to(torch.int64).sum())  # a kernel that reads t on the caller's stream
        kept.append(t)
    assert len(kept) == len(shards)
    for (_, _, host), s, t in zip(shards, sums, kept):
        assert int(s) == int(host.astype(np.int64).sum())
        assert torch.equal(t.cpu(), torch.from_numpy(host))


@pytest.mark.cuda
def test_pieces_path_on_card_matches_dense(cuda_device, tmp_path):
    """gblup_from_bed_pieces (on-card unpack, torch._int_mm pieces with a
    ragged last piece, CG) against the dense gblup_from_bed and against
    device="cpu"; a panel with missing calls is rejected."""
    import numpy as np

    from genomicbreedingmodels_tpu_torch.streaming import gblup_from_bed, gblup_from_bed_pieces

    _write_bed_trio(tmp_path / "p", 203, 700, seed=5)
    y = np.random.default_rng(6).normal(size=203)
    dense, _ = gblup_from_bed(tmp_path / "p", y, lam=0.1, block_cols=256, device=cuda_device)
    gebv, resid = gblup_from_bed_pieces(tmp_path / "p", y, lam=0.1, block_cols=256, block_rows=64,
                                        cg_iters=300, device=cuda_device)
    cpu, _ = gblup_from_bed_pieces(tmp_path / "p", y, lam=0.1, block_cols=256, block_rows=64,
                                   cg_iters=300, device="cpu")
    assert resid < 1e-3
    np.testing.assert_allclose(gebv, dense.cpu().numpy(), atol=2e-3)
    np.testing.assert_allclose(gebv, cpu, atol=1e-4)
    _write_bed_trio(tmp_path / "m", 40, 90, seed=7, missing=0.01)
    with pytest.raises(ValueError, match="missing"):
        gblup_from_bed_pieces(tmp_path / "m", np.zeros(40), device=cuda_device)


@pytest.mark.cuda
def test_sharded_grm_int8_two_thread_ranks_on_card_bit_equal(cuda_device):
    """Two thread ranks on the card over gloo: K1 on each rank's shard, the
    int32 triangles all-reduced, equal to the single-device GRM bit for bit."""
    from genomicbreedingmodels_tpu_torch.ops.grm import gram_dosage
    from genomicbreedingmodels_tpu_torch.parallel.mesh import run_ranks
    from genomicbreedingmodels_tpu_torch.parallel.sharded import sharded_grm

    g = torch.Generator(device=cuda_device).manual_seed(3)
    D = torch.randint(0, 3, (777, 4099), dtype=torch.int8, device=cuda_device, generator=g)
    before = gram_tri.LAUNCHES["gram_tri_int8"]
    outs = run_ranks(lambda m: sharded_grm(D, m), shape=(1, 2), device=cuda_device)
    assert gram_tri.LAUNCHES["gram_tri_int8"] == before + 2
    ref = gram_dosage(D, device=cuda_device)
    assert all(torch.equal(K, ref) for K in outs)


@pytest.mark.cuda
def test_sharded_gibbs_chain_with_k3_finishes_on_card(cuda_device):
    """The marker-sharded BayesC chain over two thread ranks on one card runs
    K3 on each rank's shard; its launches share the default stream, so two
    launches never co-reside and the chain cannot hang on spinning scans.
    It must finish well inside the timeout, with both ranks' bits equal."""
    import threading

    import numpy as np

    from genomicbreedingmodels_tpu_torch.parallel.mesh import run_ranks
    from genomicbreedingmodels_tpu_torch.parallel.sharded import sharded_gibbs_regression

    rng = np.random.default_rng(0)
    X = torch.as_tensor(rng.random((400, 3000)), dtype=torch.float32, device=cuda_device)
    y = rng.normal(size=400)
    before = gibbs_group.LAUNCHES["gibbs_group"]
    result = {}

    def run():
        result["outs"] = run_ranks(
            lambda m: sharded_gibbs_regression(X, y, m, model="BayesC", n_iter=20, n_burnin=5,
                                               block_size=300),
            shape=(1, 2), device=cuda_device, timeout=120.0)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=180.0)
    assert not t.is_alive(), "the sharded chain did not finish in 180 s"
    (mu0, b0), (mu1, b1) = result["outs"]
    assert mu0 == mu1 and np.array_equal(b0, b1) and np.all(np.isfinite(b0))
    assert gibbs_group.LAUNCHES["gibbs_group"] - before == 2 * 20 * 5  # 2 ranks x 20 sweeps x 5 blocks


@pytest.mark.cuda
def test_gram_auto_int8_tensor_takes_k1_on_card(cuda_device):
    from genomicbreedingmodels_tpu_torch.ops import grm

    g = torch.Generator(device=cuda_device).manual_seed(3)
    D = torch.randint(0, 3, (300, 1001), dtype=torch.int8, device=cuda_device, generator=g)
    before = dict(gram_tri.LAUNCHES)
    K = grm.gram_auto(D, device=cuda_device)
    assert gram_tri.LAUNCHES["gram_tri_int8"] == before["gram_tri_int8"] + 1
    assert gram_tri.LAUNCHES["gram_tri_float"] == before["gram_tri_float"]
    assert torch.equal(K, grm.gram_dosage(D, device=cuda_device))
    assert torch.equal(K.cpu(), grm.gram_dosage(D.cpu(), device="cpu"))  # K1 is exact


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_gram_centered_device_takes_k2_on_card(cuda_device, dtype, use_pallas):
    from genomicbreedingmodels_tpu_torch.ops import grm

    g = torch.Generator(device=cuda_device).manual_seed(4)
    X = torch.rand((300, 1001), device=cuda_device, generator=g).to(dtype)
    before = gram_tri.LAUNCHES["gram_tri_float"]
    K = grm.gram_centered_device(X, use_pallas=use_pallas, device=cuda_device)
    assert gram_tri.LAUNCHES["gram_tri_float"] == before + 1
    assert K.dtype == torch.float32
    assert torch.equal(K, grm.gram_panel(X, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("panel", ["int8", "bf16"])
def test_refit_spans_time_the_card(cuda_device, panel):
    """Inside `tracing()` a refit's spans carry device time on the card: the
    parents cover their children, `gbm.grm.kernel` holds the kernel's one
    launch, `gbm.solve.not_pd` reads 0 on a positive definite system, and
    the GEBVs are the bits of the untraced refit."""
    from genomicbreedingmodels_tpu_torch.ops import chol, grm
    from genomicbreedingmodels_tpu_torch.utils import logging as tr

    g = torch.Generator(device=cuda_device).manual_seed(5)
    if panel == "int8":
        X = torch.randint(0, 3, (1024, 8192), dtype=torch.int8, device=cuda_device, generator=g)

        def refit():
            return chol.gblup_solve_lower(grm.gram_dosage_lower(X, device=cuda_device), y, 819.2)
    else:
        X = torch.rand((1024, 8192), device=cuda_device, generator=g).to(torch.bfloat16)

        def refit():
            return chol.gblup_solve_lower(grm.gram_panel(X, device=cuda_device), y, 819.2)
    y = torch.randn(1024, device=cuda_device, generator=g)
    plain = refit()
    tr.reset()
    with tr.tracing():
        traced = refit()
    got = tr.collect()
    tr.reset()
    assert torch.equal(plain, traced)
    spans = got["spans"]
    assert all(s["device_s"] is not None and s["device_s"] > 0 for s in spans.values()), spans
    for parent in ("gbm.grm", "gbm.solve"):
        kids = sum(s["device_s"] for n, s in spans.items() if s["parent"] == parent)
        assert kids <= spans[parent]["device_s"] * 1.001
    k2 = {} if panel == "int8" else {"gbm.grm.k2.single": 1}  # 64 tiles of 128 fit one wave
    assert got["counters"] == {"gbm.solve.not_pd": 0, **k2}
    assert got["launches"]["gram_tri_int8" if panel == "int8" else "gram_tri_float"] == 1
