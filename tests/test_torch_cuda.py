"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every test is marked ``cuda`` and skips without a CUDA device.
This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch (``tests/conftest.py`` imports JAX, hence
``--noconftest``):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: attention 2e-2 in bf16 and 2e-5 in fp32 (TF32 off), as
``TOL`` in ``tests/test_kernels.py``; the SSD scan (fp32 out) atol 3e-5 and
rtol 1e-4, as its sweep there; a decode layer after its output projection
(a sum over 3072 products) 1e-4 in fp32.
"""

import pytest
import torch

from repro_torch.configs import REGISTRY
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.models import attention as attn
from repro_torch.models.runtime import use_attention_impl
from repro_torch.kernels.paged_attention import (
    decode_attention_cuda,
    paged_decode_attention_cuda,
    ring_split,
)
from repro_torch.kernels.ssd_scan import INSTANCES as SSD_INSTANCES
from repro_torch.kernels.ssd_scan import ssd_scan_cuda

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
    (4, 32, 32, 512, 112, None, None, True),     # zamba2 prefill, D=112
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
@pytest.mark.parametrize("window,cap", [(None, None), (100, None),
                                        (None, 30.0)])
@pytest.mark.parametrize("s", [33, 300, 512])
@pytest.mark.parametrize("d", [64, 96, 112, 128])
def test_flash_wgmma_instance_matches_plain_on_card(cuda_device, d, s, window,
                                                    cap):
    """Aligned bf16 at head dims 64-128 takes the wgmma + TMA instance, in
    the kernel layout and in the model layout (strided views)."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    b, hq, hkv = 2, 8, 4
    kw = dict(scale=d ** -0.5, window=window, logit_cap=cap)
    q, k, v = (torch.randn(b, s, h, d, device=cuda_device, generator=g)
               .to(torch.bfloat16) for h in (hq, hkv, hkv))
    ref = tref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), **kw)
    for qq, kk, vv in ((q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2)),
                       tuple(t.transpose(1, 2).contiguous()
                             for t in (q, k, v))):
        before = dict(flash_attention_cuda.instances)
        out = flash_attention_cuda(qq, kk, vv, **kw)
        torch.cuda.synchronize()
        assert flash_attention_cuda.instances["wgmma"] == before["wgmma"] + 1
        torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                                   rtol=2e-2)


@pytest.mark.cuda
def test_flash_instance_is_fixed_by_dtype_head_dim_and_alignment(
        cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(5)

    def run(dtype, d, offset=0):
        x = torch.randn(1, 2, 64 * d + offset, device=cuda_device,
                        generator=g).to(dtype)
        q = x[..., offset:].reshape(1, 2, 64, d)   # offset: unaligned rows
        before = dict(flash_attention_cuda.instances)
        out = flash_attention_cuda(q, q, q, scale=d ** -0.5)
        ref = tref.flash_attention_ref(q, q, q, scale=d ** -0.5)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), ref.float(),
                                   atol=CUDA_TOL[dtype], rtol=CUDA_TOL[dtype])
        return [k for k, n in flash_attention_cuda.instances.items()
                if n != before[k]]

    assert run(torch.bfloat16, 96) == ["wgmma"]
    assert run(torch.bfloat16, 112) == ["wgmma"]
    assert run(torch.bfloat16, 256) == ["mma_sync"]
    assert run(torch.bfloat16, 80) == ["mma_sync"]
    assert run(torch.bfloat16, 96, offset=1) == ["mma_sync"]
    assert run(torch.float32, 96) == ["fma_f32"]


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,d,table,tail_len,cap,split", [
    # phi3's widths, B * Hkv = 128 rows: 16 pages + tail in 9 splits of 64
    (4, 32, 32, 96, tuple(range(16)), 19, None, 64),
    (4, 32, 32, 96, tuple(range(10)), 19, None, 48),   # straddles pages
    (4, 32, 32, 96, (7, 3, 3, 19, 0, 11, 2, 2, 5, 8, 1, 4, 6, 9, 10, 12,
                     13, 14, 15, 3), 5, None, 80),    # repeated, straddles
    (4, 16, 8, 256, (5, 1, 9, 3), 7, 50.0, 16),        # gemma2, G = 2
    (4, 16, 8, 256, tuple(range(16)), 32, 50.0, 32),   # gemma2, full tail
    (2, 4, 2, 32, (), 0, None, 16),      # empty table and tail: the mean
    (2, 4, 2, 32, (3, 1), 0, None, 16),  # the tail's splits all invalid
    (2, 4, 2, 32, (), 1, 30.0, 16),      # one valid token
    (2, 4, 2, 32, (25, -3, 7), 10, None, 16),   # clamped into [0, 20)
])
def test_paged_kernel_splits_match_plain_on_card(cuda_device, dtype, b, hq,
                                                 hkv, d, table, tail_len, cap,
                                                 split):
    """The paged kernel's split-K over the page table and the tail, at the
    edges of tests/test_torch_kernels.py's split model, as ``ring_split``
    cuts the tokens on a 132-SM card; out-of-range table entries read the
    clamped slot. Twice each, since the last block of each row sets its
    ticket back to 0 for the next launch."""
    g = torch.Generator(device=cuda_device).manual_seed(8)
    page, n_slots = 32, 20
    assert ring_split(b * hkv, (len(table) + 1) * page, 132) == split

    def rnd(*shape):
        return torch.randn(*shape, device=cuda_device, generator=g).to(dtype)

    q, kp, vp = (rnd(b, hq, d), rnd(n_slots, b, page, hkv, d),
                 rnd(n_slots, b, page, hkv, d))
    kt, vt = rnd(b, page, hkv, d), rnd(b, page, hkv, d)
    t = torch.tensor(table, dtype=torch.int32, device=cuda_device)
    kw = dict(scale=d ** -0.5, logit_cap=cap)
    ref = tref.paged_decode_attention_ref(q, kp, vp, t.clamp(0, n_slots - 1),
                                          kt, vt, tail_len, **kw)
    if not table and tail_len == 0:
        mean = vt.float().mean(dim=1).repeat_interleave(hq // hkv, dim=1)
        torch.testing.assert_close(ref.float(), mean, atol=CUDA_TOL[dtype],
                                   rtol=CUDA_TOL[dtype])
    tol = CUDA_TOL[dtype]
    for _ in range(2):
        out = paged_decode_attention_cuda(q, kp, vp, t, kt, vt, tail_len,
                                          **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,c,d,pos,cap", [
    (4, 32, 32, 576, 96, 520, None),       # phi3 decode
    (4, 32, 32, 576, 112, 512, None),      # zamba2 decode
    (4, 16, 8, 4096, 256, 5000, 50.0),     # gemma2, the ring wraps
    (2, 4, 2, 64, 32, 63, None),           # ring wrap positions
    (2, 4, 2, 64, 32, 64, None),
    (2, 4, 2, 64, 32, 65, None),
    (2, 4, 2, 64, 32, 95, None),
    (2, 4, 2, 64, 32, 96, None),
    (2, 4, 2, 64, 32, 200, None),
    (1, 8, 8, 100, 16, 99, None),          # ragged last tile
    (3, 6, 1, 48, 64, 20, 30.0),           # G = 6, part of the ring empty
    (2, 4, 2, 10, 32, 7, None),            # C smaller than one split
    (2, 4, 2, 64, 32, -1, None),           # every slot masked: mean of v
])
def test_decode_kernel_matches_plain_on_card(cuda_device, dtype, b, hq, hkv,
                                             c, d, pos, cap):
    g = torch.Generator(device=cuda_device).manual_seed(2)

    def rnd(*shape):
        return torch.randn(*shape, device=cuda_device, generator=g).to(dtype)

    q, k, v = rnd(b, hq, d), rnd(b, c, hkv, d), rnd(b, c, hkv, d)
    out = decode_attention_cuda(q, k, v, pos, scale=d ** -0.5, logit_cap=cap)
    ref = tref.decode_attention_ref(q, k.transpose(1, 2), v.transpose(1, 2),
                                    pos, scale=d ** -0.5, logit_cap=cap)
    torch.cuda.synchronize()
    tol = CUDA_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    # the model-layout wrapper launches the same kernel
    wrapped = tops.decode_attention(q[:, None], k, v, torch.tensor(pos),
                                    scale=d ** -0.5, logit_cap=cap)
    torch.testing.assert_close(wrapped[:, 0], out, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cap", [None, 30.0])
@pytest.mark.parametrize("b,hkv,c,d,pos", [
    # B * Hkv = 4 rows: splits of 16 slots (4 at C=64), at the wrap positions
    (2, 2, 64, 32, 63), (2, 2, 64, 32, 64), (2, 2, 64, 32, 65),
    (2, 2, 64, 32, 95), (2, 2, 64, 32, 96), (2, 2, 64, 32, 200),
    (2, 2, 64, 32, 10),     # splits 2-4 hold no valid slot
    (2, 2, 64, 32, -1),     # all-masked ring: the mean of v
    (2, 2, 100, 32, 99),    # 7 splits, the last ragged (4 slots)
    (2, 2, 20, 32, 19),     # 2 splits, the last ragged
    (2, 2, 10, 32, 7),      # C smaller than one split
    (4, 32, 576, 96, 520),  # phi3's decode: 9 splits of 64
    (66, 8, 576, 32, 300),  # 528 rows: 2 splits of 288, 5 tiles each
    (132, 8, 576, 32, 300),  # 1056 rows: one split of 9 tiles, no merge
])
def test_decode_kernel_splits_match_plain_on_card(cuda_device, dtype, b, hkv,
                                                  c, d, pos, cap):
    """The split-K cuts of tests/test_torch_kernels.py's split model, as
    ``ring_split`` makes them on a 132-SM card; twice each, since the last
    block of each row sets its ticket back to 0 for the next launch."""
    g = torch.Generator(device=cuda_device).manual_seed(6)

    def rnd(*shape):
        return torch.randn(*shape, device=cuda_device, generator=g).to(dtype)

    hq = 2 * hkv
    q, k, v = rnd(b, hq, d), rnd(b, c, hkv, d), rnd(b, c, hkv, d)
    kw = dict(scale=d ** -0.5, logit_cap=cap)
    ref = tref.decode_attention_ref(q, k.transpose(1, 2), v.transpose(1, 2),
                                    pos, **kw)
    tol = CUDA_TOL[dtype]
    for _ in range(2):
        out = decode_attention_cuda(q, k, v, pos, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_decode_kernel_matches_plain_on_a_phi3_layer(cuda_device,
                                                              dtype):
    """phi3's attention at full width: ``attention_decode`` with an int pos
    launches the ring kernel once and matches the plain path after ``wo``;
    a (B,) pos launches it once too (the per-row cases are
    ``test_attention_decode_per_row_pos_takes_the_kernel``)."""
    cfg = REGISTRY["phi3-mini-3.8b"]
    spec = cfg.segments[0].pattern[0]
    g = torch.Generator(device=cuda_device).manual_seed(7)
    p = attn.init_attn_params(cfg, spec, dtype, cuda_device, g)
    b, max_seq = 4, 576
    cache = attn.init_attn_cache(cfg, spec, b, max_seq, dtype, cuda_device)
    for t in cache.values():
        t.copy_(torch.randn(t.shape, device=cuda_device, generator=g))
    tol = 1e-4 if dtype == torch.float32 else CUDA_TOL[dtype]
    for pos in (300, 520, 575):
        x = torch.randn(b, 1, cfg.d_model, device=cuda_device,
                        generator=g).to(dtype)
        positions = attn._rope_positions(pos, b, cuda_device)
        before = decode_attention_cuda.launches
        plain_cache = {n: t.clone() for n, t in cache.items()}
        with use_attention_impl("plain"):
            plain, _ = attn.attention_decode(cfg, spec, p, x, pos, positions,
                                             plain_cache)
        assert decode_attention_cuda.launches == before
        out, _ = attn.attention_decode(cfg, spec, p, x, pos, positions, cache)
        torch.cuda.synchronize()
        assert decode_attention_cuda.launches == before + 1
        for n in cache:
            assert torch.equal(cache[n], plain_cache[n])
        torch.testing.assert_close(out.float(), plain.float(), atol=tol,
                                   rtol=tol)
    rows = torch.full((b,), 575, dtype=torch.int32, device=cuda_device)
    before = decode_attention_cuda.launches
    attn.attention_decode(cfg, spec, p, x, rows, positions, cache)
    assert decode_attention_cuda.launches == before + 1


#: per-row positions of the ring kernel: the kernels phase's rows (at
#: C-1, a free slot at 0), rows whose ring has wrapped, and a mix
PER_ROW = [
    (4, 32, 32, 576, 96, (520, 37, 0, 575), None),      # phi3 decode
    (4, 32, 32, 576, 96, (600, 1151, 3, 575), None),    # wrapped rows
    (4, 32, 32, 576, 112, (511, 0, 0, 300), None),      # zamba2, free rows
    (3, 16, 8, 64, 256, (63, 64, 200), 50.0),           # gemma2-like, cap
    (2, 4, 2, 64, 32, (0, 10), None),                   # one valid slot
    (2, 4, 2, 10, 32, (7, 12), 30.0),                   # C below a split
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,c,d,rows,cap", PER_ROW)
def test_decode_kernel_per_row_pos_matches_plain_on_card(cuda_device, dtype,
                                                         b, hq, hkv, c, d,
                                                         rows, cap):
    """A device (B,) pos: each row at its own position in one launch,
    against the plain version with the same (B,) pos and, row by row,
    against the scalar path at batch 1 (another split, so within the
    tolerance); twice, for the tickets."""
    g = torch.Generator(device=cuda_device).manual_seed(9)

    def rnd(*shape):
        return torch.randn(*shape, device=cuda_device, generator=g).to(dtype)

    q, k, v = rnd(b, hq, d), rnd(b, c, hkv, d), rnd(b, c, hkv, d)
    kw = dict(scale=d ** -0.5, logit_cap=cap)
    pos = torch.tensor(rows, dtype=torch.int32, device=cuda_device)
    ref = tref.decode_attention_ref(q, k.transpose(1, 2), v.transpose(1, 2),
                                    pos, **kw)
    tol = CUDA_TOL[dtype]
    for _ in range(2):
        before = decode_attention_cuda.launches
        out = decode_attention_cuda(q, k, v, pos, **kw)
        torch.cuda.synchronize()
        assert decode_attention_cuda.launches == before + 1
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=tol)
    for i, r in enumerate(rows):
        one = decode_attention_cuda(q[i:i + 1], k[i:i + 1], v[i:i + 1], r,
                                    **kw)
        torch.testing.assert_close(out[i:i + 1].float(), one.float(),
                                   atol=tol, rtol=tol)
    # int64 positions, and one 0-dim tensor for every row, stay on the card
    out64 = decode_attention_cuda(q, k, v, pos.long(), **kw)
    torch.testing.assert_close(out64, out, atol=0, rtol=0)
    same = decode_attention_cuda(q, k, v, pos[0], **kw)
    torch.testing.assert_close(
        same, decode_attention_cuda(q, k, v, rows[0], **kw), atol=0, rtol=0)


@pytest.mark.cuda
def test_decode_kernel_refuses_positions_it_cannot_read(cuda_device):
    q = torch.zeros(2, 4, 32, device=cuda_device)
    k = torch.zeros(2, 64, 2, 32, device=cuda_device)
    kw = dict(scale=0.1)
    for bad in (torch.tensor([1, 2]),                          # on the host
                torch.tensor([1, 2, 3], device=cuda_device),   # not (B,)
                torch.tensor([1.0, 2.0], device=cuda_device)):  # not integer
        with pytest.raises(ValueError):
            decode_attention_cuda(q, k, k, bad, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_decode_per_row_pos_takes_the_kernel(cuda_device, dtype):
    """phi3's attention at full width with a (B,) pos, the continuous
    scheduler's decode (rows at 520, 37, a free slot at 0, 575): each call
    launches the ring kernel once, writes the cache as the plain path does
    and matches its output after ``wo``."""
    cfg = REGISTRY["phi3-mini-3.8b"]
    spec = cfg.segments[0].pattern[0]
    g = torch.Generator(device=cuda_device).manual_seed(8)
    p = attn.init_attn_params(cfg, spec, dtype, cuda_device, g)
    b, max_seq = 4, 576
    cache = attn.init_attn_cache(cfg, spec, b, max_seq, dtype, cuda_device)
    for t in cache.values():
        t.copy_(torch.randn(t.shape, device=cuda_device, generator=g))
    tol = 1e-4 if dtype == torch.float32 else CUDA_TOL[dtype]
    for rows in ((520, 37, 0, 575), (521, 38, 1, 576)):
        pos = torch.tensor(rows, dtype=torch.int32, device=cuda_device)
        x = torch.randn(b, 1, cfg.d_model, device=cuda_device,
                        generator=g).to(dtype)
        positions = attn._rope_positions(pos, b, cuda_device)
        plain_cache = {n: t.clone() for n, t in cache.items()}
        before = decode_attention_cuda.launches
        with use_attention_impl("plain"):
            plain, _ = attn.attention_decode(cfg, spec, p, x, pos, positions,
                                             plain_cache)
        assert decode_attention_cuda.launches == before
        out, _ = attn.attention_decode(cfg, spec, p, x, pos, positions, cache)
        torch.cuda.synchronize()
        assert decode_attention_cuda.launches == before + 1
        for n in cache:
            assert torch.equal(cache[n], plain_cache[n])
        torch.testing.assert_close(out.float(), plain.float(), atol=tol,
                                   rtol=tol)


def _ssd_inputs(device, b, s, h, p, n, bc_dtype, shared_bc, seed=3):
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, device=device, generator=g)

    x = rnd(b, s, h, p)
    a = -rnd(b, s, h).abs() * 0.1
    if shared_bc:   # one group broadcast to every head, head stride 0
        bm = (rnd(b, s, 1, n) * 0.3).to(bc_dtype).expand(b, s, h, n)
        cm = (rnd(b, s, 1, n) * 0.3).to(bc_dtype).expand(b, s, h, n)
    else:
        bm = (rnd(b, s, h, n) * 0.3).to(bc_dtype)
        cm = (rnd(b, s, h, n) * 0.3).to(bc_dtype)
    return x, a, bm, cm


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,n,chunk,bc_dtype,shared_bc", [
    (4, 512, 112, 64, 64, 256, torch.bfloat16, True),    # zamba2 prefill
    (4, 2048, 32, 64, 128, 256, torch.bfloat16, True),   # mamba2-370m
    (2, 128, 4, 32, 16, 32, torch.float32, False),       # tests/test_kernels
    (1, 256, 2, 64, 32, 64, torch.float32, False),
    (2, 64, 8, 16, 8, 16, torch.float32, False),
    (2, 100, 3, 40, 24, 100, torch.float32, True),       # ragged tiles
    (1, 12, 4, 32, 32, 12, torch.bfloat16, True),        # chunk < 64
])
def test_ssd_kernel_matches_plain_on_card(cuda_device, b, s, h, p, n, chunk,
                                          bc_dtype, shared_bc):
    """The instance is fixed by the type of B/C: bf16 (both serving
    shapes) takes the tensor-core ``mma_tf32``, fp32 ``fma_f32``."""
    x, a, bm, cm = _ssd_inputs(cuda_device, b, s, h, p, n, bc_dtype,
                               shared_bc)
    before = dict(ssd_scan_cuda.instances)
    y, state = ssd_scan_cuda(x, a, bm, cm, chunk)
    y_ref, state_ref = tref.ssd_scan_ref(x, a, bm, cm, chunk)
    torch.cuda.synchronize()
    taken = [k for k, v in ssd_scan_cuda.instances.items() if v != before[k]]
    assert taken == [SSD_INSTANCES[bc_dtype]], taken
    if bc_dtype == torch.bfloat16:
        assert taken == ["mma_tf32"]
    assert y.dtype == state.dtype == torch.float32
    torch.testing.assert_close(y, y_ref, atol=3e-5, rtol=1e-4)
    torch.testing.assert_close(state, state_ref, atol=3e-5, rtol=1e-4)


@pytest.mark.cuda
def test_ssd_kernel_refuses_inputs_that_require_grad(cuda_device):
    x, a, bm, cm = _ssd_inputs(cuda_device, 1, 64, 2, 32, 16, torch.float32,
                               False)
    before = ssd_scan_cuda.launches
    with pytest.raises(ValueError, match="requires grad"):
        ssd_scan_cuda(x.requires_grad_(), a, bm, cm, 64)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd_scan_cuda(x.detach(), a, bm, cm, 48)
    assert ssd_scan_cuda.launches == before
