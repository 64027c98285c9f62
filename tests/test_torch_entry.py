"""entry() twin held against __graft_entry__.entry() on the same inputs."""

import numpy as np
import pytest
import torch

import __graft_entry__
from genomicbreedingmodels_tpu_torch.entry import entry

torch.set_num_threads(2)


def test_entry_matches_jax_entry():
    fn_j, args_j = __graft_entry__.entry()
    fn_t, args_t = entry(device="cpu")
    for a, b in zip(args_j, args_t):
        assert np.array_equal(np.asarray(a), b.numpy())
    out_j = np.asarray(fn_j(*args_j), np.float64)
    out_t = fn_t(*args_t)
    assert out_t.shape == (256,) and out_t.dtype == torch.float32
    out_t = out_t.numpy().astype(np.float64)
    assert np.abs(out_t - out_j).max() <= 1e-4 * np.abs(out_j).max()


def test_entry_cuda_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()
