"""K1/K2 CUDA kernels against their plain versions, on the card only.

The kernels have no CPU mode, so these tests carry the `cuda` marker and skip
where there is no CUDA device. This file imports neither jax nor the JAX
package, so it also runs where only the port is installed:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -m cuda -q
"""

import pytest
import torch

from genomicbreedingmodels_tpu_torch.kernels import gram_tri


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions must not use TF32
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,p", [(64, 512), (129, 257), (1000, 4099)])
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


@pytest.mark.cuda
def test_cuda_wrapper_rejects_bad_inputs_on_card(cuda_device):
    with pytest.raises(ValueError, match="contiguous"):
        gram_tri.gram_tri_int8(torch.zeros(8, 4, dtype=torch.int8, device=cuda_device).T)
    with pytest.raises(TypeError):
        gram_tri.gram_tri_float(torch.zeros(4, 8, dtype=torch.float64, device=cuda_device))
    empty = gram_tri.gram_tri_int8(torch.zeros(0, 5, dtype=torch.int8, device=cuda_device))
    assert empty.shape == (0, 0)
