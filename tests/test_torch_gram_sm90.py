"""Host-side pieces and arithmetic of the Hopper Gram kernels (K1, K2), on the CPU.

- `tile_order` mirrors the kernel's `TileCursor` (csrc/gram_tri_sm90.cuh)
  and `tile_schedule` its work units (tile, marker split) over the persistent
  clusters: with each CTA writing its part of the tile (`cta_part`) under the
  kernel's predicate (row < n and col <= row), every lower-triangular element
  gets every marker block exactly once and no strict-upper element gets any;
  `marker_splits` fills the last wave. `bf16_quad` mirrors the header's rule
  for K2's bf16 schedule (2x2 clusters at large n, one CTA per tile below).
- `tma_operand` pads ragged p with zero columns and copies a misaligned base,
  leaving the Gram unchanged.
- A plain-torch model of K2's f32 path (3xTF32: hi rounded to TF32, lo = x - hi
  read as TF32, lo·hi + hi·lo + hi·hi in f32, folded every 256 markers) is held
  against float64 and against the JAX Pallas kernel in interpret mode.

The kernels themselves run only on the card: tests/test_torch_cuda_kernels.py.
"""

import numpy as np
import pytest
import torch

from genomicbreedingmodels_tpu.ops.pallas_kernels import grm_pallas
from genomicbreedingmodels_tpu_torch.kernels import gram_tri

torch.set_num_threads(2)

K2_TOL = 1e-5  # max |err| / max |G|, the kernels' tolerance against float64


def _marker_blocks(n: int, units, t, dtype) -> np.ndarray:
    """How many marker blocks the kernel's epilogues add into each element of
    the (n, n) output, over all work units (row block, column block, k0, k1)
    and every CTA of the unit's cluster, each writing its own part of the tile
    (row < n and col <= row)."""
    count = np.zeros((n, n), dtype)
    rows = np.arange(n)[:, None]
    cols = np.arange(n)[None, :]
    for i, j, k0, k1 in units:
        for rank in range(t.ctas):
            r0, c0, h, w = gram_tri.cta_part(t, i, j, rank)
            part = (slice(r0, r0 + h), slice(c0, c0 + w))
            count[part] += (k1 - k0) * (cols[:, part[1]] <= rows[part[0]]).astype(dtype)
    return count


DTYPES = [torch.int8, torch.float32, torch.bfloat16]
DTYPE_IDS = ["bn256", "bn128", "bf16"]


@pytest.mark.parametrize("n", [1, 127, 128, 129, 255, 256, 300, 1000, 1844, 2048, 8192, 8193])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_tile_schedule_covers_lower_triangle_once(n, dtype):
    # p = 16384 lets few tiles split (64 k-blocks each at least); at n = 8192
    # nothing splits, and a smaller p keeps the count array small.
    t = gram_tri.tiling(dtype, n, sms=132)
    bm, bn, p = t.tile_m, t.tile_n, 16384 if n <= 2048 else 4096
    nk = p * torch.tensor([], dtype=dtype).element_size() // 128
    order = gram_tri.tile_order(n, bm, bn)
    assert len(set(order)) == len(order)
    for i, j in order:  # every visited tile touches the lower triangle
        assert j * bn <= min(i * bm + bm, n) - 1
    sched = gram_tri.tile_schedule(n, p, dtype, sms=132)
    units = [u for cta in sched for u in cta]
    assert len(sched) == min(132 // t.ctas, len(units))
    assert len(set(units)) == len(units) and all(k0 < k1 for _, _, k0, k1 in units)
    assert {(i, j) for i, j, _, _ in units} == set(order)
    # Every lower element gets each of the nk marker blocks once, from one CTA,
    # the strict upper triangle none.
    count_dtype = np.uint8 if nk < 256 else np.uint16
    count = _marker_blocks(n, units, t, count_dtype)
    assert np.array_equal(count, nk * np.tril(np.ones((n, n), count_dtype)))
    # Units in the tile order, each tile's splits together: cluster c starts with unit c.
    flat = [(i, j) for i, j, _, _ in sorted(units, key=lambda u: (order.index(u[:2]), u[2]))]
    assert [cta[0][:2] for cta in sched] == flat[: len(sched)]


# The bf16 shapes of the port's callers on 132 SMs: the freq cell's 8192, a
# ragged 8193, bench_torch.py's gwas/cv sections at 2048 (136 tiles of 128,
# two waves), 1844 (120 tiles, one wave) and a small 300.
BF16_SCHEDULES = {8192: True, 8193: True, 4096: True, 2048: True, 1921: True, 1920: False, 1844: False,
                  300: False}


@pytest.mark.parametrize("n", sorted(BF16_SCHEDULES))
def test_bf16_schedule_by_shape(n):
    """K2 on bf16 runs 2x2 clusters at the freq cell's n and above, one CTA per
    tile at the small callers' shapes; a 2x2 cluster's strictly upper CTA on
    a diagonal tile writes nothing, and its clusters fit sms // 4."""
    t = gram_tri.tiling(torch.bfloat16, n, sms=132)
    assert gram_tri.bf16_quad(n, 132) == BF16_SCHEDULES[n]
    assert (t.cluster_m, t.cluster_n, t.tile_m, t.tile_n) == (
        (2, 2, 256, 256) if BF16_SCHEDULES[n] else (1, 1, 128, 128))
    sched = gram_tri.tile_schedule(n, 65536, torch.bfloat16, sms=132)
    assert len(sched) <= 132 // t.ctas
    for i, j, _, _ in (u for cta in sched for u in cta):
        if i != j or t.ctas == 1:
            continue
        r0, c0, h, w = gram_tri.cta_part(t, i, j, 1)  # CTA (0, 1): rows above its columns
        assert (r0, c0) == (i * 256, j * 256 + 128) and r0 + h - 1 < c0


@pytest.mark.parametrize(
    "tiles,ctas,nk,max_splits,splits",
    [
        (528, 66, 2048, 8, 1),  # K1 at 8192x262144: 8 full waves of clusters stay whole
        (36, 66, 128, 8, 1),  # K1 at 1844x16384: 64-block halves would not cut the wave
        (136, 132, 1024, 2, 2),  # K2 at 2048x32768: two waves become 1.5
        (136, 132, 512, 2, 2),  # the same in bf16
        (120, 132, 512, 2, 1),  # K2 at 1844x16384: one wave already
        (3, 66, 512, 8, 8),  # K1 at 300x65536: eight splits of 64 k-blocks
        (3, 66, 200, 8, 3),  # at least 64 k-blocks per split
        (6, 132, 127, 2, 1),  # too few k-blocks to split
        (528, 32, 4096, 2, 2),  # K2 bf16 in 2x2 clusters at 8192x262144, 32 clusters: 16.5 waves
        (528, 33, 4096, 2, 1),  # the same on 33 clusters: 16 full waves
        (136, 32, 1024, 2, 2),  # K2 bf16 in 2x2 clusters at 4096x65536
    ],
)
def test_marker_splits_fill_the_last_wave(tiles, ctas, nk, max_splits, splits):
    assert gram_tri.marker_splits(tiles, ctas, nk, max_splits) == splits


def test_cluster_tiles_at_main_shapes():
    # The tile counts the splits above are chosen for.
    assert len(gram_tri.tile_order(8192, 256, 256)) == 528
    assert len(gram_tri.tile_order(1844, 256, 256)) == 36
    assert len(gram_tri.tile_order(300, 256, 256)) == 3
    assert len(gram_tri.tile_order(2048, 128, 128)) == 136
    assert len(gram_tri.tile_order(1844, 128, 128)) == 120
    assert len(gram_tri.tile_order(8193, 256, 256)) == 561


def test_tile_order_groups_row_blocks():
    # A wave of 66 consecutive cluster tiles (132 SMs) at the headline shape
    # spans at most two groups of GROUP row blocks, so it shares their marker
    # slabs in L2.
    t = gram_tri.tiling(torch.int8, 8192, sms=132)
    order = gram_tri.tile_order(8192, t.tile_m, t.tile_n)
    wave = 132 // t.ctas
    for w in range(0, len(order), wave):
        assert len({i // gram_tri.GROUP for i, _ in order[w : w + wave]}) <= 2


def _panel(n, p, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == torch.int8:
        return torch.from_numpy(rng.integers(0, 3, size=(n, p)).astype(np.int8))
    return torch.from_numpy(rng.random((n, p)).astype(np.float32)).to(dtype)


def _gram(X):
    return gram_tri.gram_tri_int8(X) if X.dtype == torch.int8 else gram_tri.gram_tri_float(X)


@pytest.mark.parametrize("p", [15, 257, 4099])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float32])
def test_tma_operand_pads_ragged_p(p, dtype):
    X = _panel(37, p, dtype)
    Y = gram_tri.tma_operand(X)
    q = 16 // X.element_size()
    assert Y.shape == (37, -(-p // q) * q) and Y.shape[1] > p  # none of these p is aligned
    assert torch.equal(Y[:, :p], X) and not Y[:, p:].any()
    assert Y.data_ptr() % 16 == 0
    if dtype == torch.int8:
        assert torch.equal(_gram(Y), _gram(X))
    else:
        G = _gram(X)
        assert float((_gram(Y) - G).abs().max()) <= 1e-6 * float(G.abs().max())


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float32])
def test_tma_operand_copies_misaligned_base_only(dtype):
    n, p = 20, 64
    X = _panel(n, p, dtype)
    assert gram_tri.tma_operand(X) is X  # aligned base, 16-byte rows: no copy
    flat = torch.cat([X.reshape(-1)[:1], X.reshape(-1)])
    V = flat[1:].view(n, p)
    assert V.is_contiguous() and V.data_ptr() % 16
    Y = gram_tri.tma_operand(V)
    assert Y.data_ptr() % 16 == 0 and torch.equal(Y, X)


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: nearest TF32 (10 mantissa bits), ties away from zero."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _trunc_tf32(x: torch.Tensor) -> torch.Tensor:
    """How the tensor cores read an f32 operand as TF32: the low 13 bits dropped."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def gram_3xtf32_model(X: torch.Tensor, fold: int = 256) -> torch.Tensor:
    """K2's f32 arithmetic in plain torch: tril of Σ_chunks (lo·hiᵀ + hi·loᵀ + hi·hiᵀ)."""
    hi = _round_tf32(X)
    lo = _trunc_tf32(X - hi)
    acc = torch.zeros((X.shape[0],) * 2, dtype=torch.float32)
    for s in range(0, X.shape[1], fold):
        h, lc = hi[:, s : s + fold], lo[:, s : s + fold]
        acc += (lc @ h.T + h @ lc.T) + h @ h.T
    return torch.tril(acc)


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 3 * 2**-12, -(1.0 + 2**-11), 0.1], dtype=torch.float32)
    h = _round_tf32(x)
    assert not (h.view(torch.int32) & 0x1FFF).any()
    assert h[0] == 1.0 + 2**-10 and h[2] == -(1.0 + 2**-10)  # ties away from zero
    assert h[1] == 1.0 + 2**-10
    assert float((x - h).abs().max() / x.abs().max()) <= 2**-11


@pytest.mark.parametrize("n,p", [(64, 512), (129, 257), (256, 4096)])
def test_3xtf32_model_matches_float64_and_pallas(n, p):
    X = np.random.default_rng(n + p).random((n, p)).astype(np.float32)
    L = gram_3xtf32_model(torch.from_numpy(X)).numpy()
    exact = np.tril(X.astype(np.float64) @ X.T.astype(np.float64))
    scale = np.abs(exact).max()
    assert np.abs(L - exact).max() <= K2_TOL * scale
    assert not np.triu(L, 1).any()
    pallas = np.tril(np.asarray(grm_pallas(X, center=False)))
    assert np.abs(L - pallas).max() <= K2_TOL * scale


@pytest.fixture(scope="module")
def tile_cursor_exe(tmp_path_factory):
    """The kernel header's tile enumeration (`TileCursor`, with the constants
    above it) compiled for the host by the system C++ compiler: prints the
    (row block, column block) tiles for `n bm bn` in the kernel's order."""
    import re
    import shutil
    import subprocess
    from pathlib import Path

    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the header's TileCursor")
    header = (Path(gram_tri.__file__).resolve().parent.parent / "csrc" / "gram_tri_sm90.cuh").read_text()
    m = re.search(r"namespace gbm_sm90 \{\n(.*?)// ---- PTX helpers", header, re.S)
    d = tmp_path_factory.mktemp("tile_cursor")
    (d / "main.cpp").write_text(
        "#include <cstdio>\n#include <cstdlib>\n#define __host__\n#define __device__\n"
        "namespace gbm_sm90 {\n" + m.group(1) + "}\n"
        "int main(int argc, char** argv) {\n"
        "  if (argc == 3) return std::printf(\"%d\\n\", gbm_sm90::bf16_quad(atoll(argv[1]), atoi(argv[2]))) < 0;\n"
        "  gbm_sm90::TileCursor cur(atoll(argv[1]), atoi(argv[2]), atoi(argv[3]));\n"
        "  int i, j;\n  while (cur.next(i, j)) std::printf(\"%d %d\\n\", i, j);\n  return 0;\n}\n")
    subprocess.run([cxx, "-std=c++17", "-O1", "-o", str(d / "tiles"), str(d / "main.cpp")], check=True)
    return d / "tiles"


@pytest.mark.parametrize("n", [1, 255, 256, 4097, 8192, 10000])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_kernel_tile_cursor_visits_tile_order_once(tile_cursor_exe, n, dtype):
    # Past GROUP row blocks the header's cursor must start each group at its
    # own first row block: a cursor that revisits column 0 of earlier row
    # blocks adds split tiles twice (atomics) and wastes a wave unsplit.
    import subprocess

    t = gram_tri.tiling(dtype, n, sms=132)
    bm, bn = t.tile_m, t.tile_n
    out = subprocess.run([str(tile_cursor_exe), str(n), str(bm), str(bn)], capture_output=True,
                         text=True, check=True).stdout.split()
    tiles = [(int(a), int(b)) for a, b in zip(out[::2], out[1::2])]
    assert tiles == gram_tri.tile_order(n, bm, bn)


@pytest.mark.parametrize("n", [1, 300, 1844, 1920, 1921, 2048, 2560, 4096, 8192, 8193, 50000])
@pytest.mark.parametrize("sms", [114, 132])
def test_kernel_bf16_schedule_rule_is_the_header_rule(tile_cursor_exe, n, sms):
    """`bf16_quad` mirrors the header's rule, which picks the kernel launched."""
    import subprocess

    out = subprocess.run([str(tile_cursor_exe), str(n), str(sms)], capture_output=True, text=True,
                         check=True).stdout
    assert bool(int(out)) == gram_tri.bf16_quad(n, sms)
