"""The PyTorch port's kernels against the JAX package's.

On the CPU the port runs its kernels' plain versions (``kernels/ref.py``);
those are held against the Pallas kernels (interpret mode) and the JAX
oracles in ``repro.kernels.ref``, on the sweeps of
``tests/test_kernels.py``. Inputs come from numpy with a seed. Tolerance:
attention 2e-5 in fp32, the SSD scan atol 3e-5 and rtol 1e-4 (as its sweep
in ``tests/test_kernels.py``) — the two sides sum in different orders.
``test_torch_cuda.py`` holds the hand-written kernels against the plain
versions on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.paged_attention import (
    decode_attention_pallas,
    paged_decode_attention_pallas,
)
from repro.kernels.ssd_scan import ssd_scan_pallas
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.paged_attention import (
    decode_attention_cuda,
    paged_decode_attention_cuda,
    ring_split,
)
from repro_torch.kernels.ssd_scan import ssd_scan_cuda
from repro_torch.models import runtime

ATOL = 2e-5


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(out_torch, out_jax, atol=ATOL):
    np.testing.assert_allclose(out_torch.detach().numpy(), np.asarray(out_jax),
                               atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# flash attention (prefill)
# ---------------------------------------------------------------------------


def _flash_inputs(seed, b, hq, hkv, s, d):
    rng = np.random.default_rng(seed)
    return (_randn(rng, b, hq, s, d), _randn(rng, b, hkv, s, d),
            _randn(rng, b, hkv, s, d))


@pytest.mark.parametrize("b,hq,hkv,s,d", [
    (2, 4, 2, 64, 32),
    (1, 4, 4, 96, 64),
    (2, 8, 1, 33, 16),     # ragged seq, G = 8
    (1, 2, 2, 128, 128),
    (1, 2, 1, 40, 96),     # phi3's head_dim, G = 2
])
def test_flash_plain_matches_pallas_and_ref(b, hq, hkv, s, d):
    q, k, v = _flash_inputs(0, b, hq, hkv, s, d)
    scale = d ** -0.5
    out = tref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                   scale=scale)
    pallas = flash_attention_pallas(*map(jnp.asarray, (q, k, v)), scale=scale,
                                    block_q=32, block_k=32)
    oracle = jref.flash_attention_ref(*map(jnp.asarray, (q, k, v)),
                                      scale=scale)
    _close(out, pallas)
    _close(out, oracle)


@pytest.mark.parametrize("window,cap,causal", [
    (None, None, True),
    (32, None, True),
    (None, 30.0, True),
    (16, 50.0, True),
    (None, None, False),
])
def test_flash_plain_flags_match_pallas(window, cap, causal):
    q, k, v = _flash_inputs(1, 2, 4, 2, 80, 32)
    kw = dict(scale=0.2, causal=causal, window=window, logit_cap=cap)
    out = tref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)), **kw)
    pallas = flash_attention_pallas(*map(jnp.asarray, (q, k, v)),
                                    block_q=16, block_k=16, **kw)
    _close(out, pallas)
    _close(out, jref.flash_attention_ref(*map(jnp.asarray, (q, k, v)), **kw))


def test_flash_gemma2_head_dim_window_and_cap():
    """head_dim 256, G = 2, a window shorter than the sequence, cap 50."""
    q, k, v = _flash_inputs(2, 1, 4, 2, 48, 256)
    kw = dict(scale=256 ** -0.5, window=20, logit_cap=50.0)
    out = tref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)), **kw)
    _close(out, flash_attention_pallas(*map(jnp.asarray, (q, k, v)),
                                       block_q=16, block_k=16, **kw))


def test_flash_model_layout_wrapper_matches_jax_ops():
    """``ops.flash_attention`` takes (B,S,H,D) like ``repro.kernels.ops``;
    on the CPU it runs the plain version and launches nothing."""
    rng = np.random.default_rng(3)
    q, k, v = (_randn(rng, 2, 33, 4, 16), _randn(rng, 2, 33, 2, 16),
               _randn(rng, 2, 33, 2, 16))
    before = flash_attention_cuda.launches
    out = tops.flash_attention(*map(torch.from_numpy, (q, k, v)), scale=0.25,
                               window=8, logit_cap=30.0)
    assert flash_attention_cuda.launches == before
    assert out.shape == (2, 33, 4, 16)
    _close(out, jops.flash_attention(*map(jnp.asarray, (q, k, v)), scale=0.25,
                                     window=8, logit_cap=30.0))


# ---------------------------------------------------------------------------
# paged decode attention
# ---------------------------------------------------------------------------


def _paged_inputs(seed, b, hq, hkv, d, page, n_pool):
    rng = np.random.default_rng(seed)
    return (_randn(rng, b, hq, d), _randn(rng, n_pool, b, page, hkv, d),
            _randn(rng, n_pool, b, page, hkv, d), _randn(rng, b, page, hkv, d),
            _randn(rng, b, page, hkv, d))


def _paged_both(arrays, table, tail_len, **kw):
    q, kp, vp, kt, vt = arrays
    t_args = (torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
              torch.tensor(table, dtype=torch.int32), torch.from_numpy(kt),
              torch.from_numpy(vt), tail_len)
    j_args = (jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
              jnp.asarray(table, jnp.int32), jnp.asarray(kt), jnp.asarray(vt),
              jnp.int32(tail_len))
    out = tref.paged_decode_attention_ref(*t_args, **kw)
    return (out, paged_decode_attention_pallas(*j_args, **kw),
            jref.paged_decode_attention_ref(*j_args, **kw))


@pytest.mark.parametrize("hq,hkv", [(2, 2), (8, 2), (4, 1)])   # GQA groups
@pytest.mark.parametrize("cap", [None, 30.0])
def test_paged_plain_gqa_and_softcap_match_pallas(hq, hkv, cap):
    arrays = _paged_inputs(10, 2, hq, hkv, 32, 8, 5)
    out, pallas, oracle = _paged_both(arrays, (3, 0, 4), 5,
                                      scale=32 ** -0.5, logit_cap=cap)
    _close(out, pallas)
    _close(out, oracle)


@pytest.mark.parametrize("table,tail_len", [
    ((0, 1, 2, 3, 4), 5),   # all pages, partial tail
    ((2, 4), 0),            # tail empty
    ((1, 3), 8),            # tail exactly full
    ((), 3),                # tail-only attention (no pages yet)
    ((), 1),                # single-token tail
])
def test_paged_plain_tail_boundaries_match_pallas(table, tail_len):
    arrays = _paged_inputs(11, 2, 4, 2, 32, 8, 5)
    out, pallas, oracle = _paged_both(arrays, table, tail_len,
                                      scale=32 ** -0.5)
    _close(out, pallas)
    _close(out, oracle)


def test_paged_empty_table_and_empty_tail_is_mean_of_v_tail():
    """With the finite NEG_INF every score is equally masked, so the
    softmax is uniform: both JAX versions and the port return the mean of
    v_tail, not NaN."""
    arrays = _paged_inputs(12, 2, 4, 2, 32, 8, 3)
    out, pallas, oracle = _paged_both(arrays, (), 0, scale=32 ** -0.5)
    v_tail = arrays[4]                               # (B, page, Hkv, D)
    mean = np.repeat(v_tail.mean(axis=1), 2, axis=1)  # (B, Hq, D), G = 2
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy(), mean, atol=ATOL)
    _close(out, pallas)
    _close(out, oracle)


def test_paged_plain_ref_is_bitwise_the_gather_path():
    """The plain paged version IS the gather/concat math of the cache's
    ``attend`` — the identity that makes the fused path token-identical."""
    q, kp, vp, kt, vt = map(torch.from_numpy, _paged_inputs(13, 2, 4, 2, 32,
                                                            8, 6))
    for table, tl in [((5, 1, 2), 4), ((0,), 0), ((), 7)]:
        t = torch.tensor(table, dtype=torch.int32)
        ref = tref.paged_decode_attention_ref(q, kp, vp, t, kt, vt, tl,
                                              scale=32 ** -0.5)
        idx = t.long()
        gather = tref.paged_attend_gathered(q, kp[idx], vp[idx], kt, vt, tl,
                                            scale=32 ** -0.5)
        assert torch.equal(ref, gather)


# ---------------------------------------------------------------------------
# ring-cache decode attention
# ---------------------------------------------------------------------------


def _decode_both(seed, b, hq, hkv, c, d, pos, cap=None):
    """The port's plain version, the Pallas kernel and the JAX oracle on one
    set of inputs (kernel layout: k/v (B,Hkv,C,D))."""
    rng = np.random.default_rng(seed)
    q, k, v = (_randn(rng, b, hq, d), _randn(rng, b, hkv, c, d),
               _randn(rng, b, hkv, c, d))
    kw = dict(scale=d ** -0.5, logit_cap=cap)
    out = tref.decode_attention_ref(*map(torch.from_numpy, (q, k, v)), pos,
                                    **kw)
    j_args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(pos))
    return (out, decode_attention_pallas(*j_args, block_k=32, **kw),
            jref.decode_attention_ref(*j_args, **kw))


@pytest.mark.parametrize("b,hq,hkv,c,d,pos", [
    (2, 4, 2, 64, 32, 5),
    (2, 4, 2, 64, 32, 63),
    (2, 4, 2, 64, 32, 200),   # wrapped ring
    (1, 8, 8, 100, 16, 99),
    (3, 6, 1, 48, 64, 20),
])
def test_decode_plain_matches_pallas_and_ref(b, hq, hkv, c, d, pos):
    out, pallas, oracle = _decode_both(20, b, hq, hkv, c, d, pos)
    _close(out, pallas)
    _close(out, oracle)


@pytest.mark.parametrize("pos", [63, 64, 65, 95, 96, 200])
@pytest.mark.parametrize("cap", [None, 30.0])
def test_decode_plain_ring_wrap_matches_pallas(pos, cap):
    """Positions at, just past and mid-way through the ring's block
    boundaries, where the validity mask wraps inside a kv block."""
    out, pallas, oracle = _decode_both(21, 2, 4, 2, 64, 32, pos, cap)
    _close(out, pallas)
    _close(out, oracle)


def test_decode_model_layout_wrapper_matches_jax_ops():
    """``ops.decode_attention`` takes q (B,1,Hq,D) and the model's
    (B,C,Hkv,D) cache like ``repro.kernels.ops``; on the CPU it runs the
    plain version and launches nothing."""
    rng = np.random.default_rng(22)
    q, k, v = (_randn(rng, 2, 1, 4, 16), _randn(rng, 2, 40, 2, 16),
               _randn(rng, 2, 40, 2, 16))
    before = decode_attention_cuda.launches
    for pos in (7, 39, 57):
        out = tops.decode_attention(*map(torch.from_numpy, (q, k, v)),
                                    torch.tensor(pos), scale=0.25,
                                    logit_cap=20.0)
        assert out.shape == (2, 1, 4, 16)
        _close(out, jops.decode_attention(*map(jnp.asarray, (q, k, v)),
                                          jnp.int32(pos), scale=0.25,
                                          logit_cap=20.0))
    assert decode_attention_cuda.launches == before


def _split_k_decode(q, k, v, pos, bounds, *, scale, logit_cap=None):
    """A plain model of the ring kernel's split-K: each split [bounds[i],
    bounds[i + 1]) of the ring keeps its own (m, l, acc) over its slots
    (invalid slots score NEG_INF, as in the kernel), then the merge rescales
    by exp(m_i - m), sums and divides (l == 0 -> 1). q (B,Hq,D), k/v
    (B,Hkv,C,D) → (B,Hq,D), fp32."""
    b, hq, d = q.shape
    hkv, c = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, hkv, hq // hkv, d) * scale
    j = torch.arange(c)
    valid = (pos - torch.remainder(pos - j, c)) >= 0
    ms, ls, accs = [], [], []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        sc = torch.einsum("bkgd,bkcd->bkgc", qf, k[:, :, lo:hi].float())
        if logit_cap is not None:
            sc = logit_cap * torch.tanh(sc / logit_cap)
        sc = torch.where(valid[lo:hi], sc, tref.NEG_INF)
        m = sc.max(dim=-1).values
        p = torch.exp(sc - m[..., None])
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bkgc,bkcd->bkgd", p, v[:, :, lo:hi].float()))
    m = torch.stack(ms).max(dim=0).values
    w = [torch.exp(mi - m) for mi in ms]
    l = sum(wi * li for wi, li in zip(w, ls))
    acc = sum(wi[..., None] * ai for wi, ai in zip(w, accs))
    out = acc / torch.where(l == 0, 1.0, l)[..., None]
    return out.reshape(b, hq, d)


def _split_k_check(seed, b, hq, hkv, c, d, pos, bounds, cap):
    rng = np.random.default_rng(seed)
    q, k, v = (_randn(rng, b, hq, d), _randn(rng, b, hkv, c, d),
               _randn(rng, b, hkv, c, d))
    kw = dict(scale=d ** -0.5, logit_cap=cap)
    out = _split_k_decode(*map(torch.from_numpy, (q, k, v)), pos, bounds,
                          **kw)
    np.testing.assert_allclose(
        out.numpy(), tref.decode_attention_ref(
            *map(torch.from_numpy, (q, k, v)), pos, **kw).numpy(),
        atol=1e-5, rtol=0)
    _close(out, jref.decode_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(pos), **kw),
        atol=1e-5)
    return out, v


@pytest.mark.parametrize("cap", [None, 30.0])
@pytest.mark.parametrize("n_split", [1, 2, 9, 64])
@pytest.mark.parametrize("pos", [63, 64, 65, 95, 96, 200])
def test_split_k_merge_matches_both_refs(pos, n_split, cap):
    """The partials-and-merge arithmetic of the ring kernel, split into 1,
    2, 9 (ragged) and C splits, at the ring's wrap positions."""
    bounds = np.linspace(0, 64, n_split + 1).round().astype(int).tolist()
    _split_k_check(23, 2, 4, 2, 64, 32, pos, bounds, cap)


@pytest.mark.parametrize("cap", [None, 30.0])
@pytest.mark.parametrize("c,pos,split", [
    (64, -1, 16),     # all-masked ring: uniform weights, the mean of v
    (64, 10, 16),     # splits 2-4 hold no valid slot: weight 0 each
    (100, 99, 32),    # ragged last split of 4 slots
    (100, 150, 48),   # wrapped, ragged
    (576, 520, 64),   # phi3's ring at the kernel's split (9 splits)
])
def test_split_k_edges_match_both_refs(c, pos, split, cap):
    """Equal splits of ``split`` slots and a ragged last one, as the kernel
    cuts the ring."""
    bounds = list(range(0, c, split)) + [c]
    out, v = _split_k_check(24, 2, 4, 2, c, 32, pos, bounds, cap)
    if pos < 0:
        mean = np.repeat(v.mean(axis=2), 2, axis=1)   # (B, Hq, D), G = 2
        np.testing.assert_allclose(out.numpy(), mean, atol=1e-5)


@pytest.mark.parametrize("rows,c,n_sm,split", [
    (128, 576, 132, 64),    # phi3 / zamba2 decode, B=4: 9 splits
    (16, 4096, 132, 64),    # gemma2 global layer, B=2: 64 splits
    (4, 64, 132, 16),       # a small ring: the least split
    (4, 10, 132, 16),       # C smaller than one split
    (4096, 576, 132, 576),  # enough rows alone: one split
    (128, 100, 132, 16),
])
def test_ring_split_is_a_multiple_of_16_sized_for_the_card(rows, c, n_sm,
                                                           split):
    got = ring_split(rows, c, n_sm)
    assert got == split and got % 16 == 0


# ---------------------------------------------------------------------------
# Mamba2 SSD chunked scan
# ---------------------------------------------------------------------------


def _ssd_inputs(seed, b, s, h, p, n):
    """x, a = dt*A (negative), B, C as in ``tests/test_kernels.py``."""
    rng = np.random.default_rng(seed)
    return (_randn(rng, b, s, h, p), -np.abs(_randn(rng, b, s, h)) * 0.1,
            _randn(rng, b, s, h, n) * 0.3, _randn(rng, b, s, h, n) * 0.3)


def _ssd_close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=3e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 128, 4, 32, 16, 32),
    (1, 256, 2, 64, 32, 64),
    (2, 64, 8, 16, 8, 16),
])
def test_ssd_plain_matches_pallas_and_ref(b, s, h, p, n, chunk):
    arrays = _ssd_inputs(30, b, s, h, p, n)
    y, state = tref.ssd_scan_ref(*map(torch.from_numpy, arrays), chunk)
    assert y.shape == (b, s, h, p) and state.shape == (b, h, p, n)
    jargs = [jnp.asarray(x) for x in arrays]
    for jy, jstate in (ssd_scan_pallas(*jargs, chunk),
                       jref.ssd_scan_ref(*jargs, chunk)):
        _ssd_close(y, jy)
        _ssd_close(state, jstate)


def test_ssd_model_layout_wrapper_reads_head_broadcast_b_and_c():
    """``ops.ssd_scan`` on the CPU runs the plain version and launches
    nothing; B and C broadcast to every head with stride 0 (as the model
    passes one group) give what the materialised copies give in JAX."""
    x, a, bm, cm = _ssd_inputs(31, 2, 96, 4, 16, 8)
    bm1, cm1 = bm[:, :, :1], cm[:, :, :1]
    tb = torch.from_numpy(bm1).expand(2, 96, 4, 8)
    tc = torch.from_numpy(cm1).expand(2, 96, 4, 8)
    assert tb.stride(2) == 0
    before = ssd_scan_cuda.launches
    y, state = tops.ssd_scan(torch.from_numpy(x), torch.from_numpy(a), tb,
                             tc, 32)
    assert ssd_scan_cuda.launches == before
    jy, jstate = jops.ssd_scan(jnp.asarray(x), jnp.asarray(a),
                               jnp.repeat(jnp.asarray(bm1), 4, axis=2),
                               jnp.repeat(jnp.asarray(cm1), 4, axis=2), 32)
    _ssd_close(y, jy)
    _ssd_close(state, jstate)


# ---------------------------------------------------------------------------
# dispatch: CPU tensors take the plain version, CUDA entry points refuse them
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_path_and_kernels_refuse_them():
    assert runtime.attention_impl(torch.device("cpu")) == "plain"
    with runtime.use_attention_impl("kernel"):
        assert runtime.attention_impl(torch.device("cpu")) == "plain"
    with pytest.raises(ValueError):
        with runtime.use_attention_impl("pallas"):
            pass
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention_cuda(q, q, q, scale=1.0)
    qd, pages, tail = torch.zeros(1, 2, 16), torch.zeros(1, 1, 4, 2, 16), \
        torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        paged_decode_attention_cuda(qd, pages, pages,
                                    torch.zeros(1, dtype=torch.int32),
                                    tail, tail, 1, scale=1.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        decode_attention_cuda(qd, tail, tail, 3, scale=1.0)
    x = torch.zeros(1, 8, 2, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ssd_scan_cuda(x, torch.zeros(1, 8, 2), x, x, 8)
    counts = tops.launch_counts()
    assert set(counts) == {"flash_attention", "paged_decode_attention",
                           "decode_attention", "ssd_scan"}
