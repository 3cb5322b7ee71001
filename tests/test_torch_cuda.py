"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every test is marked ``cuda`` and skips without a CUDA device.
This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch (``tests/conftest.py`` imports JAX, hence
``--noconftest``):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: 2e-2 in bf16 and 2e-5 in fp32 (TF32 off), as ``TOL`` in
``tests/test_kernels.py``.
"""

import pytest
import torch

from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.paged_attention import paged_decode_attention_cuda

CUDA_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    # fp32 references in full fp32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,s,d,window,cap,causal", [
    (4, 32, 32, 512, 96, None, None, True),      # phi3 prefill
    (2, 16, 8, 300, 256, 64, 50.0, True),        # gemma2 local layer
    (2, 8, 1, 33, 16, None, 30.0, True),         # ragged, G = 8
    (1, 4, 2, 100, 64, 32, None, True),          # head_dim 64, window
    (1, 2, 2, 128, 128, None, None, True),       # head_dim 128
    (1, 4, 2, 70, 96, None, None, False),        # non-causal
])
def test_flash_kernel_matches_plain_on_card(cuda_device, dtype, b, hq, hkv,
                                            s, d, window, cap, causal):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(b, h, s, d, device=cuda_device, generator=g)
               .to(dtype) for h in (hq, hkv, hkv))
    kw = dict(scale=d ** -0.5, causal=causal, window=window, logit_cap=cap)
    out = flash_attention_cuda(q, k, v, **kw)
    ref = tref.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    tol = CUDA_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,d,table,tail_len,cap", [
    (4, 32, 32, 96, tuple(range(16)), 19, None),  # phi3 decode
    (4, 16, 8, 256, (5, 1, 9, 3), 7, 50.0),       # gemma2, scrambled table
    (2, 4, 2, 32, (), 0, None),                   # tail only, empty tail
    (2, 8, 2, 32, (3, 0), 32, None),              # full tail
])
def test_paged_kernel_matches_plain_on_card(cuda_device, dtype, b, hq, hkv, d,
                                            table, tail_len, cap):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    page, n_slots = 32, 20

    def rnd(*shape):
        return torch.randn(*shape, device=cuda_device, generator=g).to(dtype)

    args = (rnd(b, hq, d), rnd(n_slots, b, page, hkv, d),
            rnd(n_slots, b, page, hkv, d),
            torch.tensor(table, dtype=torch.int32, device=cuda_device),
            rnd(b, page, hkv, d), rnd(b, page, hkv, d), tail_len)
    out = paged_decode_attention_cuda(*args, scale=d ** -0.5, logit_cap=cap)
    ref = tref.paged_decode_attention_ref(*args, scale=d ** -0.5,
                                          logit_cap=cap)
    torch.cuda.synchronize()
    tol = CUDA_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
