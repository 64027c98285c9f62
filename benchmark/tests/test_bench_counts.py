"""The frozen operation and byte counts are `bench_torch.py:headline_split`'s."""

import pytest
import torch

from counts import gblup_refit


@pytest.mark.parametrize("n,p", [(64, 256), (96, 1000)])
def test_counts_are_headline_split_s(n, p):
    import bench_torch

    gen = torch.Generator().manual_seed(1)
    D = torch.randint(0, 3, (n, p), dtype=torch.int8, generator=gen)
    y = torch.randn(n, generator=gen)
    _, _, split = bench_torch.headline_split(D, y, 0.1 * p, lambda fn: 0.0)
    theirs = [(ops, peak, nbytes) for _, ops, peak, nbytes in split.values()]
    ours = [(ops, peak, nbytes) for _, ops, peak, nbytes in gblup_refit.stages(n, p, "int8")]
    assert ours == theirs


def test_least_times_at_the_headline():
    n, p = 8192, 262_144
    st = {name: gblup_refit.least_seconds(o, k, b) for name, o, k, b in gblup_refit.stages(n, p, "int8")}
    ms = [v * 1e3 for v in st.values()]
    assert ms[0] == pytest.approx(8.891, abs=1e-3)  # K1, operations-bound (PERF.md's table)
    assert ms[4] == pytest.approx(2.735, abs=1e-3)  # potrf
    assert all(m == pytest.approx(0.160, abs=1e-3) for m in ms[1:4])  # the memory passes
    assert gblup_refit.refit_least_seconds(n, p, "int8") * 1e3 == pytest.approx(12.19, abs=0.01)
    assert gblup_refit.gram_least_seconds(n, p, "bf16") * 1e3 == pytest.approx(17.79, abs=0.01)


def test_peaks_are_the_data_sheet_s():
    assert gblup_refit.PEAKS == {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}
    assert gblup_refit.HBM_BYTES_PER_S == 3.35e12
