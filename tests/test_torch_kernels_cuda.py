"""The CUDA kernels against their plain PyTorch versions, on a GPU.

A CUDA kernel has no CPU mode, so these cases skip without a card (the
CPU suite holds the plain versions against the JAX reference in
tests/test_torch_dc.py).  The file imports no JAX, so it also runs on a
machine with a GPU and no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py

Comparisons are exact (integer bit patterns).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops

SHAPES = [(256, 64, 24), (16, 64, 8), (16, 96, 16), (16, 128, 24), (5, 64, 24),
          (16, 32, 0), (130, 64, 32)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,w,k", SHAPES)
@pytest.mark.parametrize("kern", ops.KERNELS, ids=lambda kern: kern.name)
def test_cuda_kernel_matches_plain(cuda_device, kern, b, w, k):
    rng = np.random.default_rng(b * 1000 + w + k)
    texts = torch.from_numpy(rng.integers(0, 5, size=(b, w)).astype(np.int8))
    pats = torch.from_numpy(rng.integers(0, 5, size=(b, w)).astype(np.int8))
    t, p = texts.to(cuda_device), pats.to(cuda_device)
    launches = kern.wrapper.launches
    d, s = kern.wrapper(t, p, w=w, k=k)
    torch.cuda.synchronize()
    assert kern.wrapper.launches == launches + 1
    d_ref, s_ref = kern.plain(t, p, w=w, k=k)
    assert torch.equal(d, d_ref)
    assert torch.equal(s, s_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("kern", ops.KERNELS, ids=lambda kern: kern.name)
def test_cuda_kernel_rejects_bad_input(cuda_device, kern):
    t = torch.zeros((4, 64), dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError):
        kern.wrapper(t, t, w=64, k=33)  # beyond the kernel's register rows
    with pytest.raises(TypeError):
        kern.wrapper(t.int(), t.int(), w=64, k=8)
