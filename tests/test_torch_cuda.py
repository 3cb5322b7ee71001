"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every test is marked ``cuda`` and skips without a CUDA device.
This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch (``tests/conftest.py`` imports JAX, hence
``--noconftest``):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: attention 2e-2 in bf16 and 2e-5 in fp32 (TF32 off), as
``TOL`` in ``tests/test_kernels.py``; the SSD scan (fp32 out) atol 3e-5 and
rtol 1e-4, as its sweep there; a decode layer after its output projection
(a sum over 3072 products) 1e-4 in fp32. The KV page codecs (plain
PyTorch on the card, no kernel) give the CPU's payload bytes and scale on
the card, and round-trip a bf16 page through a pinned codec tier within
``roundtrip_bound`` plus the decode's bf16 rounding.
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
    (4, 16, 16, 64, 64, None, None, True),       # whisper decoder prompt
    (4, 64, 8, 512, 128, None, None, True),      # qwen2-vl prefill, G = 8
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
    (4, 16, 16, 64, tuple(range(16)), 19, None),  # whisper's heads
    (4, 64, 8, 128, tuple(range(16)), 19, None),  # qwen2-vl's, G = 8
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
    (4, 16, 16, 448, 64, 447, None),       # whisper decode, full ring
    (4, 64, 8, 576, 128, 520, None),       # qwen2-vl decode, G = 8
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
    (4, 16, 16, 448, 64, (191, 63, 0, 447), None),      # whisper's heads
    (4, 64, 8, 576, 128, (520, 37, 0, 575), None),      # qwen2-vl's, G = 8
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


def _refuses_grad(call, tensors, launches_of):
    """``call(*tensors)`` raises for every input that requires grad, and
    launches nothing; with no input requiring grad it runs."""
    before = launches_of.launches
    for i in range(len(tensors)):
        ins = [t.detach().requires_grad_(j == i)
               for j, t in enumerate(tensors)]
        with pytest.raises(ValueError, match="requires grad"):
            call(*ins)
    assert launches_of.launches == before
    call(*[t.detach() for t in tensors])
    assert launches_of.launches == before + 1


@pytest.mark.cuda
def test_flash_kernel_refuses_inputs_that_require_grad(cuda_device):
    q = torch.randn(1, 4, 16, 32, device=cuda_device)
    k = torch.randn(1, 2, 16, 32, device=cuda_device)
    _refuses_grad(lambda q, k, v: flash_attention_cuda(q, k, v, scale=0.1),
                  (q, k, k.clone()), flash_attention_cuda)


@pytest.mark.cuda
def test_paged_kernel_refuses_inputs_that_require_grad(cuda_device):
    page, d = 8, 32
    q = torch.randn(2, 4, d, device=cuda_device)
    pages = torch.randn(3, 2, page, 2, d, device=cuda_device)
    tail = torch.randn(2, page, 2, d, device=cuda_device)
    table = torch.tensor([2, 0], dtype=torch.int32, device=cuda_device)
    _refuses_grad(
        lambda q, kp, vp, kt, vt: paged_decode_attention_cuda(
            q, kp, vp, table, kt, vt, 5, scale=0.1),
        (q, pages, pages.clone(), tail, tail.clone()),
        paged_decode_attention_cuda)


@pytest.mark.cuda
def test_decode_kernel_refuses_inputs_that_require_grad(cuda_device):
    q = torch.randn(2, 4, 32, device=cuda_device)
    k = torch.randn(2, 64, 2, 32, device=cuda_device)
    pos = torch.tensor([3, 40], dtype=torch.int32, device=cuda_device)
    _refuses_grad(
        lambda q, k, v: decode_attention_cuda(q, k, v, pos, scale=0.1),
        (q, k, k.clone()), decode_attention_cuda)


# ---------------------------------------------------------------------------
# KV page codecs on the card (no kernel: plain PyTorch on the device)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_codec_encode_on_card_equals_cpu(cuda_device, name, dtype):
    """The encode on the card gives the CPU's payload bytes and scale for a
    phi3-width page (B=4, 32 tokens, 32 heads, D=96)."""
    from repro_torch.pool import make_codec
    g = torch.Generator().manual_seed(3)
    x = (torch.randn(4, 32, 32, 96, generator=g) * 3).to(dtype)
    codec = make_codec(name)
    qc, sc = codec.encode(x)
    qg, sg = codec.encode(x.to(cuda_device))
    assert sg.device.type == "cuda" and sg.dim() == 0
    assert float(sg) == float(sc)
    assert torch.equal(qg.cpu().view(torch.uint8), qc.view(torch.uint8))
    y = codec.decode(qg, sg, dtype)
    assert torch.equal(y.cpu(), codec.decode(qc, sc, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["int8", "fp8"])
def test_codec_backend_round_trip_on_the_copy_stream(cuda_device, name):
    """A page produced on the compute stream, parked in a codec-wrapped
    pinned host tier and prefetched back through the transfer engine (its
    copy stream), with no synchronize in between: the page comes back
    within ``roundtrip_bound``, from a pinned payload buffer that a re-put
    reuses."""
    from repro_torch.pool import default_pool, make_codec, roundtrip_bound
    pool = default_pool(device=cuda_device, codec=name, codec_below="host")
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(4, 32, 32, 96, device=cuda_device, generator=g,
                    dtype=torch.bfloat16)
    for _ in range(8):      # queue compute ahead of the put on the stream
        x = (x * 1.0001).to(torch.bfloat16)
    pool.put("pg", x, tier="host")
    h = pool.entries["pg"].handle
    assert h.payload.is_pinned() and h.scale.device.type == "cuda"
    assert pool.entries["pg"].nbytes == x.numel() + 4
    payload = h.payload
    z = x * 2
    for page in (x, z):
        if page is z:
            pool.put("pg", z, tier="host")
            assert pool.entries["pg"].handle.payload is payload
        y = pool.prefetch("pg").wait()
        absmax = float(page.float().abs().max())
        # the decode rounds to bf16: half a bf16 ulp of the page's largest
        # element (at most absmax * 2^-8) on top of the codec's bound
        bound = roundtrip_bound(make_codec(name), absmax) + absmax * 2.0 ** -8
        assert float((y.float() - page.float()).abs().max()) <= bound
    pool.close()


@pytest.mark.cuda
def test_copy_stream_timing_matches_the_profiler(cuda_device):
    """Twelve 8 MiB pages parked in the pinned host tier and fetched back
    through the transfer engine (one worker, so its copies run in issue
    order), then parked again into the same pinned buffers and fetched
    again, as the serving loop does every step, that second round under
    ``torch.profiler``, telemetry on: each ``transfer`` span
    (the copy's interval between its two timing events on the copy
    stream, mapped onto the host clock) lies within 0.1 ms of the
    profiler's ``Memcpy HtoD`` interval on the host clock, on the copy
    stream's lane, and each pair's ``device_s`` is the profiler's copy
    time within 5 %. The profiler's clock is put on the host's as
    ``perfbench/harness/devtrace.py`` does: a spin kernel launched right
    after a synchronised host reading, at the start and at the stop. The
    engine's hidden and exposed counters equal the overlap analyzer's
    decomposition of the same round's trace."""
    import time
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.obs import OverlapAnalyzer, Tracer
    from repro_torch.pool import default_pool
    from repro_torch.pool.transfer import copy_lane

    def anchor():
        torch.cuda.synchronize()
        t = time.perf_counter()
        torch.cuda._sleep(1000)
        return t

    n = 12
    torch.cuda._sleep(1000)       # the spin kernel loaded before it anchors
    torch.cuda.synchronize()
    tracer = Tracer()
    pool = default_pool(device=cuda_device, transfer_workers=1,
                        tracer=tracer)
    g = torch.Generator(device=cuda_device).manual_seed(2)
    pages = [torch.randn(4 << 20, device=cuda_device, generator=g,
                         dtype=torch.bfloat16) for _ in range(n)]
    for i, page in enumerate(pages):
        pool.put(f"p{i}", page, tier="host")
        pool.prefetch(f"p{i}").wait()
    torch.cuda.synchronize()
    tracer.clear()
    before = pool.transfer.clock()
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    t_start = anchor()
    for i, page in enumerate(pages):
        pool.put(f"p{i}", page, tier="host")
    fetched = [pool.prefetch(f"p{i}").wait() for i in range(n)]
    t_stop = anchor()
    torch.cuda.synchronize()
    prof.stop()
    after = pool.transfer.clock()
    rep = OverlapAnalyzer.from_tracer(tracer).report()
    assert rep["waits_overlapped"] + rep["waits_blocked"] == n
    for key in ("hidden_s", "exposed_s"):
        assert rep[key] == pytest.approx(after[key] - before[key],
                                         rel=1e-6, abs=1e-9), key
    # a blocking fetch's copy is still in flight when it returns: it is
    # filed with the host's seconds
    assert torch.equal(pool.get("p0"), pages[0])
    assert pool.transfer.clock()["pairs"]["host->device"]["transfers"] == \
        after["pairs"]["host->device"]["transfers"] + 1
    pool.close()
    assert all(torch.equal(a, b) for a, b in zip(fetched, pages))
    raw = [(e.name(), e.start_ns() * 1e-9, e.end_ns() * 1e-9)
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA]
    spins = sorted(s for name, s, _ in raw if "spin_kernel" in name)
    assert len(spins) == 2
    off = 0.5 * ((spins[0] - t_start) + (spins[-1] - t_stop))
    copies = {d: sorted((s - off, e - off) for name, s, e in raw
                        if "Memcpy" in name and d in name)
              for d in ("HtoD", "DtoH")}
    assert len(copies["HtoD"]) == len(copies["DtoH"]) == n
    spans = sorted((e for e in tracer.events() if e.name == "transfer"),
                   key=lambda e: e.args["seq"])
    assert len(spans) == n
    assert {e.tid for e in spans} == {copy_lane(pool.device)}
    offsets = [(sp.ts - s, sp.end - e)
               for sp, (s, e) in zip(spans, copies["HtoD"])]
    worst = max(max(abs(a), abs(b)) for a, b in offsets)
    print(f"copy-stream spans against the profiler: worst offset "
          f"{worst * 1e6:.1f} us over {n} copies; profiler anchor drift "
          f"{(spins[-1] - t_stop) - (spins[0] - t_start):.2e} s; "
          "(start, end) offsets us: "
          + " ".join(f"({a * 1e6:.1f},{b * 1e6:.1f})" for a, b in offsets))
    assert worst <= 1e-4
    for pair, d in (("host->device", "HtoD"), ("device->host", "DtoH")):
        device_s = after["pairs"][pair]["device_s"] \
            - before["pairs"][pair]["device_s"]
        profiled = sum(e - s for s, e in copies[d])
        print(f"{pair}: device_s {device_s * 1e3:.4f} ms, profiler "
              f"{profiled * 1e3:.4f} ms")
        assert device_s == pytest.approx(profiled, rel=0.05)


@pytest.mark.cuda
def test_a_fetch_job_lands_mixed_tier_pages_in_batch_cache_slots(
        cuda_device):
    """Sixteen 4 MiB pages, eight left in the device tier and eight spilled
    to pinned host memory, fetched as one job (``prefetch_many``) into the
    (layer, slot) slices of a batch cache, two layers by eight slots, in
    an order that mixes the tiers: every slice holds its page bit for bit,
    and a kernel queued on the compute stream after the wait reads them.
    With telemetry on the job is one ``transfer`` span per source tier on
    the copy stream's lane, the host pages' first, and the host tier's
    ``device_s`` is the profiler's ``Memcpy HtoD`` time within 5 %."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.obs import Tracer
    from repro_torch.pool import default_pool
    from repro_torch.pool.transfer import copy_lane

    n, numel = 16, 2 << 20
    page_bytes = numel * 2
    tracer = Tracer()
    pool = default_pool(device=cuda_device, device_capacity=8 * page_bytes,
                        transfer_workers=1, tracer=tracer)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    pages = [torch.randn(numel, device=cuda_device, generator=g,
                         dtype=torch.bfloat16) for _ in range(n)]
    for i, page in enumerate(pages):
        pool.put(f"p{i}", page, tier="device")
    keys = [f"p{i}" for i in (0, 15, 1, 14, 2, 13, 3, 12, 4, 11, 5, 10, 6,
                              9, 7, 8)]
    tiers = [pool.tier_of(k) for k in keys]
    assert tiers.count("host") == tiers.count("device") == 8
    cache = torch.zeros(2, 8, numel, device=cuda_device,
                        dtype=torch.bfloat16)
    dests = [cache[i % 2, i // 2] for i in range(n)]
    want = torch.stack([pages[int(k[1:])] for k in keys]).float().sum(-1)
    assert pool.prefetch_many(keys, dests).wait() is None   # warm-up
    cache.zero_()
    torch.cuda.synchronize()
    tracer.clear()
    before = pool.transfer.clock()
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    assert pool.prefetch_many(keys, dests).wait() is None
    got = torch.stack(dests).float().sum(-1)   # on the compute stream
    torch.cuda.synchronize()
    prof.stop()
    after = pool.transfer.clock()
    lane = copy_lane(pool.device)
    pool.close()
    assert torch.equal(got, want)
    for k, d in zip(keys, dests):
        assert torch.equal(d, pages[int(k[1:])])
    spans = [e for e in tracer.events() if e.name == "transfer"]
    assert [(e.args["src"], e.args["dst"]) for e in spans] == \
        [("host", "device"), ("device", "device")]
    assert len({e.args["seq"] for e in spans}) == 1
    assert {e.tid for e in spans} == {lane}
    assert spans[0].end <= spans[1].ts + 2e-5
    raw = [(e.name(), (e.end_ns() - e.start_ns()) * 1e-9)
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA and "Memcpy" in e.name()]
    for pair, kind in (("host->device", "HtoD"), ("device->device", "DtoD")):
        delta = {f: after["pairs"][pair][f] - before["pairs"][pair][f]
                 for f in ("transfers", "bytes", "device_s")}
        profiled = sum(s for name, s in raw if kind in name)
        print(f"{pair}: {delta['transfers']} pages, device_s "
              f"{delta['device_s'] * 1e3:.4f} ms, profiler "
              f"{profiled * 1e3:.4f} ms over "
              f"{sum(1 for name, _ in raw if kind in name)} copies")
        assert delta["transfers"] == 8
        assert delta["bytes"] == 8 * page_bytes
    host_s = after["pairs"]["host->device"]["device_s"] \
        - before["pairs"]["host->device"]["device_s"]
    assert host_s == pytest.approx(
        sum(s for name, s in raw if "HtoD" in name), rel=0.05)


# ---------------------------------------------------------------------------
# training: no kernel lies on the path; the offload machinery does
# ---------------------------------------------------------------------------


def _train_model(cuda_device, dtype):
    import dataclasses
    from repro_torch.models.model import build_model
    cfg = REGISTRY["phi3-mini-3.8b"].reduced()
    cfg = dataclasses.replace(cfg, segments=tuple(
        dataclasses.replace(s, repeats=2) for s in cfg.segments))
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda_device).manual_seed(0),
                        dtype, cuda_device)
    toks = torch.randint(0, cfg.vocab_size, (2, 65), device=cuda_device,
                         generator=torch.Generator(
                             device=cuda_device).manual_seed(1))
    batch = {"tokens": toks[:, :-1].int(), "targets": toks[:, 1:].int()}
    return model, params, batch


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_streamed_moment_update_equals_the_resident_update(cuda_device,
                                                           dtype):
    """Three AdamW steps with the moments on the device, and with them in
    pinned host memory streamed one (leaf, layer) slice at a time: the
    parameters and the moments are equal bit for bit."""
    from repro_torch.offload import optstate
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.optim.adamw import tree_items, tree_map
    _, params, _ = _train_model(cuda_device, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    grads = [tree_map(lambda p: torch.randn(p.shape, generator=gen,
                                            device=cuda_device).to(p.dtype),
                      params) for _ in range(3)]
    runs = []
    for streamed in (False, True):
        p = tree_map(torch.clone, params)
        st = adamw_init(p)
        counts = optstate.MomentCounts()
        if streamed:
            st = st._replace(mu=optstate.host_offload_state(st.mu),
                             nu=optstate.host_offload_state(st.nu))
            assert all(m.is_pinned() for _, m in tree_items((st.mu, st.nu)))
        for g in grads:
            p, st, _ = adamw_update(
                g, st, p, 1e-3,
                stream=(lambda w, c, h: optstate.streamed_update(w, c, h,
                                                                 counts))
                if streamed else None)
        torch.cuda.synchronize()
        runs.append((p, st, counts))
    (p0, s0, _), (p1, s1, counts) = runs
    assert all(torch.equal(a, b) for (_, a), (_, b)
               in zip(tree_items(p0), tree_items(p1)))
    assert all(torch.equal(a, b.to(cuda_device)) for (_, a), (_, b)
               in zip(tree_items((s0.mu, s0.nu)), tree_items((s1.mu, s1.nu))))
    n = sum(x.numel() for _, x in tree_items(params))
    assert counts.bytes_fetched == counts.bytes_parked == 3 * 2 * 4 * n


@pytest.mark.cuda
def test_offload_remat_parks_pinned_and_equals_none(cuda_device):
    """The offload policy on the card: every parked activation sits in
    pinned host memory, the backward fetches them back, and the gradients
    equal those of keeping every activation, bit for bit."""
    from repro_torch.offload import policies
    from repro_torch.optim.adamw import tree_items, tree_map
    model, params, batch = _train_model(cuda_device, torch.bfloat16)
    pinned = []
    park = policies._OffloadScope.park

    def spy(self, x):
        parked = park(self, x)
        pinned.append(parked.host.is_pinned())
        return parked

    policies._OffloadScope.park = spy
    try:
        grads = []
        policy = policies.offload_remat_policy(policies.OFFLOADABLE_NAMES)
        for pol in (None, policy):
            p = tree_map(lambda x: x.detach().clone().requires_grad_(True),
                         params)
            with use_attention_impl("plain"):
                model.loss(p, batch, remat_policy=pol).backward()
            grads.append([x.grad for _, x in tree_items(p)])
    finally:
        policies._OffloadScope.park = park
    assert pinned and all(pinned)
    assert policy.counts.parked == 3 * 2
    assert policy.counts.bytes_fetched > 0
    assert all(torch.equal(a, b) for a, b in zip(*grads))


@pytest.mark.cuda
def test_train_step_on_card_launches_no_kernel(cuda_device):
    """The train step runs the plain path on the card (the kernels are
    forward-only): its loss falls, and no kernel counts a launch."""
    from repro_torch.training import TrainStepConfig, init_train_state
    from repro_torch.training import make_train_step
    model, _, batch = _train_model(cuda_device, torch.bfloat16)
    ts = TrainStepConfig(remat="offload", offload_opt_state=True,
                         peak_lr=1e-3, warmup=1)
    params, opt = init_train_state(
        model, torch.Generator(device=cuda_device).manual_seed(0),
        torch.bfloat16, ts, cuda_device)
    step = make_train_step(model, ts)
    before = dict(tops.launch_counts())
    losses = []
    for _ in range(4):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert dict(tops.launch_counts()) == before
    assert losses[-1] < losses[0]


# ---------------------------------------------------------------------------
# MoE (granite) and the new head shapes
# ---------------------------------------------------------------------------

#: (label, q heads, kv heads, head dim) of granite-moe-3b-a800m (G = 3) and
#: codeqwen1.5-7b (MHA at 128)
NEW_HEADS = [("granite", 24, 8, 64), ("codeqwen", 32, 32, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("label,hq,hkv,d", NEW_HEADS)
def test_kernels_accept_granite_and_codeqwen_heads(cuda_device, label, hq,
                                                   hkv, d, dtype):
    """Flash (a 512-token prefill), the ring kernel at a scalar and a (B,)
    pos over a 576-slot ring, and the paged kernel (16 pages + a tail) at
    the new paths' heads, each against its plain version."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    tol = CUDA_TOL[dtype]

    def rnd(*shape):
        return torch.randn(*shape, device=cuda_device, generator=g).to(dtype)

    b, s, c, scale = 4, 512, 576, d ** -0.5
    q, k, v = rnd(b, hq, s, d), rnd(b, hkv, s, d), rnd(b, hkv, s, d)
    torch.testing.assert_close(
        flash_attention_cuda(q, k, v, scale=scale).float(),
        tref.flash_attention_ref(q, k, v, scale=scale).float(), atol=tol,
        rtol=tol)
    q, k, v = rnd(b, hq, d), rnd(b, c, hkv, d), rnd(b, c, hkv, d)
    rows = torch.tensor([520, 37, 0, 575], dtype=torch.int32,
                        device=cuda_device)
    for pos in (520, rows):
        torch.testing.assert_close(
            decode_attention_cuda(q, k, v, pos, scale=scale).float(),
            tref.decode_attention_ref(q, k.transpose(1, 2), v.transpose(1, 2),
                                      pos, scale=scale).float(),
            atol=tol, rtol=tol)
    args = (rnd(b, hq, d), rnd(20, b, 32, hkv, d), rnd(20, b, 32, hkv, d),
            torch.arange(16, dtype=torch.int32, device=cuda_device),
            rnd(b, 32, hkv, d), rnd(b, 32, hkv, d), 19)
    torch.testing.assert_close(
        paged_decode_attention_cuda(*args, scale=scale).float(),
        tref.paged_decode_attention_ref(*args, scale=scale).float(),
        atol=tol, rtol=tol)


def _granite_model(cuda_device, layers=2):
    """granite-moe-3b-a800m's routing at full width (d_model 1536, 40
    experts, top-8, d_ff_expert 512) over ``layers`` layers, bf16."""
    import dataclasses
    from repro_torch.models.model import build_model
    cfg = REGISTRY["granite-moe-3b-a800m"]
    cfg = dataclasses.replace(cfg, vocab_size=512, segments=tuple(
        dataclasses.replace(s, repeats=layers) for s in cfg.segments))
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda_device).manual_seed(0),
                        torch.bfloat16, cuda_device)
    return model, params


@pytest.mark.cuda
def test_moe_dispatch_and_combine_are_bitwise_deterministic(cuda_device):
    """One granite MoE layer at 1024 tokens, forward and backward twice:
    output, aux loss and every gradient equal bit for bit (the dispatch
    and the combine are gathers added in a fixed order, never atomics)."""
    from repro_torch.models import moe
    from repro_torch.models.transformer import _index
    model, params = _granite_model(cuda_device, layers=1)
    p0 = _index(params["segments"][0], 0)["p0"]["ffn"]
    g = torch.Generator(device=cuda_device).manual_seed(4)
    x0 = torch.randn(2, 512, model.cfg.d_model, device=cuda_device,
                     generator=g).to(torch.bfloat16)
    w = torch.randn(x0.shape, device=cuda_device, generator=g)
    runs = []
    for _ in range(2):
        p = {k: t.detach().clone().requires_grad_(True) for k, t in p0.items()}
        x = x0.clone().requires_grad_(True)
        out, aux = moe.moe_ffn(model.cfg, p, x)
        ((out.float() * w).sum() + aux).backward()
        runs.append([out, aux, x.grad, *(p[k].grad for k in sorted(p))])
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert p0["router"].dtype == torch.float32


@pytest.mark.cuda
def test_granite_training_losses_equal_across_memory_modes(cuda_device):
    """Three train steps of a two-layer full-width granite in ``none`` and
    in ``offload`` with the moments offloaded: losses and parameters equal
    bit for bit, and no kernel counts a launch."""
    from repro_torch.optim.adamw import tree_items
    from repro_torch.training import TrainStepConfig, init_train_state
    from repro_torch.training import make_train_step
    model, _ = _granite_model(cuda_device)
    toks = torch.randint(0, model.cfg.vocab_size, (2, 257),
                         device=cuda_device, generator=torch.Generator(
                             device=cuda_device).manual_seed(1))
    batch = {"tokens": toks[:, :-1].int(), "targets": toks[:, 1:].int()}
    before = dict(tops.launch_counts())
    out = []
    for remat, opt in (("none", False), ("offload", True)):
        ts = TrainStepConfig(remat=remat, offload_opt_state=opt,
                             peak_lr=1e-3, warmup=1)
        params, state = init_train_state(
            model, torch.Generator(device=cuda_device).manual_seed(0),
            torch.bfloat16, ts, cuda_device)
        step = make_train_step(model, ts)
        losses = []
        for _ in range(3):
            params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
        out.append((losses, [x for _, x in tree_items(params)]))
    assert out[0][0] == out[1][0]
    assert out[0][0][-1] < out[0][0][0]
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
    assert dict(tops.launch_counts()) == before


# ---------------------------------------------------------------------------
# the model under a one-card mesh
# ---------------------------------------------------------------------------


@pytest.fixture
def card_mesh(cuda_device):
    """``make_debug_mesh((1, 1))`` on the card: a single-rank NCCL group,
    destroyed after the test."""
    from repro_torch.launch.mesh import close_mesh, make_debug_mesh
    mesh = make_debug_mesh((1, 1))
    try:
        yield mesh
    finally:
        close_mesh()


@pytest.mark.cuda
def test_debug_mesh_on_the_card(card_mesh):
    assert card_mesh.device_type == "cuda"
    assert card_mesh.mesh_dim_names == ("data", "model")
    assert tuple(card_mesh.shape) == (1, 1)


@pytest.mark.cuda
def test_phi3_under_the_rules_is_bit_for_bit_and_launches_kernels(card_mesh):
    """phi3 ``.reduced()`` in bf16, parameters and cache placed by the
    launch layer: prefill logits and two decode steps equal the calls
    outside the rules bit for bit, and the flash and ring-decode launch
    counts rise under the mesh as they do outside it (one launch per
    attention layer per call)."""
    import contextlib
    from repro_torch.launch.shardings import (cache_shardings,
                                              param_shardings, place)
    from repro_torch.models.model import build_model
    from repro_torch.sharding.rules import DEFAULT_RULES, axis_rules
    cfg = REGISTRY["phi3-mini-3.8b"].reduced()
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen, torch.bfloat16)
    tok = torch.randint(0, cfg.vocab_size, (2, 64), device="cuda",
                        generator=gen, dtype=torch.int32)
    rules = dict(DEFAULT_RULES)
    p = place(params, param_shardings(params, card_mesh, rules), card_mesh)

    def local(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    def run(prm, cache, mesh):
        ctx = axis_rules(rules, mesh) if mesh is not None \
            else contextlib.nullcontext()
        with torch.no_grad(), ctx:
            lg, _ = model.prefill(prm, {"tokens": tok}, cache)
            logits = [local(lg)]
            for i in range(2):
                nxt = logits[-1].argmax(-1).to(torch.int32)
                lg, _ = model.decode_step(prm, cache, nxt, 64 + i)
                logits.append(local(lg))
        return logits

    n_attn = sum(seg.repeats * len(seg.pattern) for seg in cfg.segments)
    tops.reset_launch_counts()
    want = run(params, model.init_cache(2, 80, torch.bfloat16), None)
    plain = tops.launch_counts()
    assert plain["flash_attention"] == n_attn
    assert plain["decode_attention"] == 2 * n_attn
    cache = model.init_cache(2, 80, torch.bfloat16)
    dcache = place(cache, cache_shardings(cache, card_mesh, rules), card_mesh)
    tops.reset_launch_counts()
    got = run(p, dcache, card_mesh)
    assert tops.launch_counts() == plain
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("capacity_factor", [0.3, 4.0])
def test_moe_ffn_sharded_on_the_card_is_moe_ffn(card_mesh, capacity_factor):
    """granite's routing (40 experts, top-8) at narrow widths in bf16 on
    the card: ``moe_ffn`` under the 1×1 mesh (``_moe_ffn_sharded``) equals
    the local path bit for bit."""
    import dataclasses
    from repro_torch.launch.shardings import param_shardings, place
    from repro_torch.models import moe
    from repro_torch.sharding.rules import DEFAULT_RULES, axis_rules
    base = REGISTRY["granite-moe-3b-a800m"]
    cfg = dataclasses.replace(base.reduced(), d_model=64, moe=dataclasses.
                              replace(base.moe, d_ff_expert=32,
                                      capacity_factor=capacity_factor))
    gen = torch.Generator(device="cuda").manual_seed(1)
    p = moe.init_moe_params(cfg, torch.bfloat16, torch.device("cuda"), gen)
    x = torch.randn(4, 64, cfg.d_model, device="cuda", generator=gen,
                    dtype=torch.bfloat16)
    want_out, want_aux = moe.moe_ffn(cfg, p, x)
    tree = {"ffn": p}
    placed = place(tree, param_shardings(tree, card_mesh, DEFAULT_RULES),
                   card_mesh)
    with axis_rules(DEFAULT_RULES, card_mesh):
        out, aux = moe.moe_ffn(cfg, placed["ffn"], x)
    assert torch.equal(out.full_tensor(), want_out)
    assert torch.equal(aux.full_tensor(), want_aux)


@pytest.mark.cuda
@pytest.mark.parametrize("remat", ["full", "offload"])
@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "granite-moe-3b-a800m"])
def test_training_under_the_rules_is_bit_for_bit(card_mesh, arch, remat):
    """Two train steps of ``arch`` ``.reduced()`` in bf16 with a recompute
    in the backward, parameters and moments placed on the 1×1 mesh, under
    the rules: losses and parameters equal the steps outside them bit for
    bit. The backward (and the recompute in it) runs on autograd's device
    thread, which re-enters the forward's rules and mesh; without them
    granite's recompute would take the local MoE path on ``DTensor``
    weights. No kernel counts a launch (training runs the plain path)."""
    import contextlib
    from repro_torch.launch.shardings import param_shardings, place
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import AdamWState, tree_items
    from repro_torch.sharding.rules import DEFAULT_RULES, axis_rules
    from repro_torch.training import (TrainStepConfig, init_train_state,
                                      make_train_step)
    cfg = REGISTRY[arch].reduced()
    model = build_model(cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 65), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(1))
    batch = {"tokens": toks[:, :-1].int(), "targets": toks[:, 1:].int()}
    ts = TrainStepConfig(remat=remat, peak_lr=1e-3, warmup=1)
    rules = dict(DEFAULT_RULES)

    def local(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    before = dict(tops.launch_counts())
    out = []
    for under in (False, True):
        params, opt = init_train_state(
            model, torch.Generator(device="cuda").manual_seed(0),
            torch.bfloat16, ts, "cuda")
        ctx = contextlib.nullcontext()
        if under:
            params = place(params, param_shardings(params, card_mesh, rules),
                           card_mesh)
            opt = AdamWState(opt.step, *(
                place(m, param_shardings(m, card_mesh, rules), card_mesh)
                for m in (opt.mu, opt.nu)))
            ctx = axis_rules(rules, card_mesh)
        step = make_train_step(model, ts)
        losses = []
        with ctx:
            for _ in range(2):
                params, opt, m = step(params, opt, batch)
                losses.append(local(m["loss"]))
        out.append((losses, [local(x) for _, x in tree_items(params)]))
    assert all(torch.equal(a, b) for a, b in zip(out[0][0], out[1][0]))
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
    assert dict(tops.launch_counts()) == before


# ---------------------------------------------------------------------------
# the continuous scheduler's decode step, replayed as a CUDA graph
# ---------------------------------------------------------------------------

GRAPH_BATCH, GRAPH_SEQ = 4, 64
#: (arch, kv_offload): both benchmark families resident and offloaded;
#: gemma2 (embeddings scaled on the device, a sliding window, soft caps)
#: and zamba2 (a recurrent state written in place) resident
GRAPH_RUNS = [("phi3-mini-3.8b", False), ("phi3-mini-3.8b", True),
              ("granite-moe-3b-a800m", False),
              ("granite-moe-3b-a800m", True), ("gemma2-9b", False),
              ("zamba2-7b", False)]


def _graph_trace(vocab):
    """Nine requests over four slots: rows join and retire mid-stream, greedy
    and sampled, 30-odd decode steps."""
    import numpy as np
    from repro_torch.sched import Request
    rng = np.random.default_rng(5)
    shapes = [(12, 9, 0.0), (30, 14, 0.0), (7, 20, 1.0), (21, 3, 2.0),
              (16, 11, 4.0), (5, 16, 6.0), (40, 6, 9.0), (9, 12, 12.0),
              (25, 8, 15.0)]
    return [Request(tokens=rng.integers(0, vocab, size=s, dtype=np.int32),
                    max_new_tokens=n, arrival=a, seed=i,
                    temperature=0.7 if i % 3 == 2 else 0.0, top_k=8)
            for i, (s, n, a) in enumerate(shapes)]


def _graph_sched_run(cuda_device, model, params, kv_offload, eager):
    """The trace through ``ContinuousScheduler`` in bf16: every decode
    step's logits (copied out) and ring-kernel launches, the tokens in the
    trace's order, the clock. ``eager`` calls the eager step in the
    graph's place."""
    from repro_torch.offload.kvcache import worst_case_page_bytes
    from repro_torch.pool import default_pool
    from repro_torch.sched import ContinuousScheduler, SchedulerConfig
    pool = None
    if kv_offload:
        row = worst_case_page_bytes(model.cache_specs(1, GRAPH_SEQ,
                                                      torch.bfloat16))
        # a tier of 1.5 rows: pages spill to pinned host and come back
        pool = default_pool(device=cuda_device, device_capacity=int(1.5 * row))
    sched = ContinuousScheduler(model, params, SchedulerConfig(
        max_batch=GRAPH_BATCH, max_seq=GRAPH_SEQ, cache_dtype=torch.bfloat16,
        kv_offload=kv_offload), pool=pool)
    step = sched._decode_graph.decode if eager else sched._decode_graph
    logits, launches = [], []

    def recorded(*args):
        r0 = decode_attention_cuda.launches
        out = step(*args)
        launches.append(decode_attention_cuda.launches - r0)
        logits.append(out[0].clone())
        return out
    sched._decode = recorded
    out = sched.run(_graph_trace(model.cfg.vocab_size))
    clock = sched.clock
    sched.close()
    if pool is not None:
        pool.close()
    return logits, launches, [out[r].tolist() for r in sorted(out)], clock


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kv_offload", GRAPH_RUNS,
                         ids=[f"{a.split('-')[0]}-{'kv_offload' if o else 'resident'}"
                              for a, o in GRAPH_RUNS])
def test_decode_graph_replays_the_eager_scheduler_bit_for_bit(
        cuda_device, arch, kv_offload):
    """The scheduler's decode replayed as a CUDA graph against the same
    scheduler calling the eager step: every step's logits and every token
    equal bit for bit while rows join and retire; one capture, every later
    step replayed; the ring kernel's launch counter grows by one launch a
    layer on every step, replays included."""
    from repro_torch.models.model import build_model
    cfg = REGISTRY[arch].reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda_device).manual_seed(0),
                        torch.bfloat16, cuda_device)
    n_attn = sum(seg.repeats * sum(s.mixer != "mamba2" for s in seg.pattern)
                 for seg in cfg.segments)
    e_logits, e_launches, e_tokens, e_clock = _graph_sched_run(
        cuda_device, model, params, kv_offload, eager=True)
    g_logits, g_launches, g_tokens, g_clock = _graph_sched_run(
        cuda_device, model, params, kv_offload, eager=False)
    n = len(e_logits)
    assert n >= 20 and len(g_logits) == n
    assert g_tokens == e_tokens
    for i, (a, b) in enumerate(zip(g_logits, e_logits)):
        assert torch.equal(a, b), f"decode step {i}"
    assert e_launches == g_launches == [n_attn] * n
    assert (e_clock.decode_captures, e_clock.decode_replays,
            e_clock.decode_eager) == (0, 0, 0)
    assert (g_clock.decode_captures, g_clock.decode_replays,
            g_clock.decode_eager) == (1, n - 1, 0)


@pytest.mark.cuda
def test_decode_graph_never_replays_the_kernel_graph_under_plain(
        cuda_device):
    """Switching to the plain attention path changes the graph's key: the
    kernel graph is dropped, the plain step is captured anew (no ring
    launch counted) and equals the eager plain step bit for bit; switching
    back captures the kernel step again."""
    from repro_torch.models.model import build_model
    from repro_torch.sched.graph import DecodeGraph
    from repro_torch.sched.scheduler import SchedClock
    from repro_torch.serving.engine import jit_decode
    cfg = REGISTRY["phi3-mini-3.8b"].reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda_device).manual_seed(0),
                        torch.bfloat16, cuda_device)
    step = jit_decode(model)
    clock = SchedClock()
    g = DecodeGraph(step, clock)
    cache = model.init_cache(GRAPH_BATCH, GRAPH_SEQ, torch.bfloat16,
                             device=cuda_device)
    twin = model.init_cache(GRAPH_BATCH, GRAPH_SEQ, torch.bfloat16,
                            device=cuda_device)
    n_attn = cfg.n_layers
    tok = torch.arange(GRAPH_BATCH, device=cuda_device,
                       dtype=torch.int32)[:, None]

    def run(i, impl):
        pos = torch.tensor([i, i + 3, 0, 2 * i], device=cuda_device,
                           dtype=torch.int32)
        r0 = decode_attention_cuda.launches
        with use_attention_impl(impl):
            got, _ = g(params, cache, tok, pos)
            want, _ = step(params, twin, tok, pos)
        assert torch.equal(got, want), (i, impl)
        return decode_attention_cuda.launches - r0

    assert [run(i, "kernel") for i in range(3)] == [2 * n_attn] * 3
    assert [run(i, "plain") for i in range(3, 6)] == [0, 0, 0]
    assert (clock.decode_captures, clock.decode_replays) == (2, 4)
    assert [run(i, "kernel") for i in range(6, 8)] == [2 * n_attn] * 2
    assert (clock.decode_captures, clock.decode_replays,
            clock.decode_eager) == (3, 5, 0)
