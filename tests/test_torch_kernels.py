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

import shutil

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
from repro.models import attention as jax_attn
from repro_torch.kernels import build
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


def _split_k_merge(q, k, v, valid, bounds, *, scale, logit_cap=None):
    """A plain model of the decode kernels' split-K: each split [bounds[i],
    bounds[i + 1]) of the C token rows keeps its own (m, l, acc) over its
    rows (rows where ``valid`` is False score NEG_INF, as in the kernels),
    then the merge rescales by exp(m_i - m), sums and divides (l == 0 ->
    1). q (B,Hq,D), k/v (B,Hkv,C,D), valid (C,) bool, or (B,C) for rows at
    their own positions → (B,Hq,D), fp32."""
    b, hq, d = q.shape
    hkv = k.shape[1]
    qf = q.float().reshape(b, hkv, hq // hkv, d) * scale
    ms, ls, accs = [], [], []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        sc = torch.einsum("bkgd,bkcd->bkgc", qf, k[:, :, lo:hi].float())
        if logit_cap is not None:
            sc = logit_cap * torch.tanh(sc / logit_cap)
        ok = valid[..., lo:hi]
        sc = torch.where(ok[:, None, None, :] if ok.dim() == 2 else ok, sc,
                         tref.NEG_INF)
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


def _split_k_decode(q, k, v, pos, bounds, *, scale, logit_cap=None):
    """The ring kernel's split-K (:func:`_split_k_merge`) with the ring's
    validity at ``pos`` (an int, or a (B,) tensor read per row): slot j
    holds token pos - ((pos - j) mod C)."""
    c = k.shape[2]
    j = torch.arange(c)
    p = pos if isinstance(pos, int) else pos[:, None]
    valid = (p - torch.remainder(p - j, c)) >= 0
    return _split_k_merge(q, k, v, valid, bounds, scale=scale,
                          logit_cap=logit_cap)


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


def _jax_rows(q, k, v, rows, **kw):
    """JAX's oracle row by row, each row at its own scalar position."""
    return jnp.concatenate([jref.decode_attention_ref(
        jnp.asarray(q[i:i + 1]), jnp.asarray(k[i:i + 1]),
        jnp.asarray(v[i:i + 1]), jnp.int32(r), **kw)
        for i, r in enumerate(rows)])


#: (C, per-row positions): a row at C - 1, a free slot decoded at 0 (one
#: valid slot), rows whose ring has wrapped, rows mid-ring
PER_ROW = [(576, (520, 37, 0, 575)), (576, (600, 1151, 3, 575)),
           (64, (0, 63, 64, 200)), (10, (7, 12, 0, 9)), (48, (20, 47, 5, 96))]


@pytest.mark.parametrize("cap", [None, 30.0])
@pytest.mark.parametrize("c,rows", PER_ROW)
def test_decode_plain_per_row_pos_matches_jax(c, rows, cap):
    """``decode_attention_ref`` at a (B,) pos against JAX's oracle row by
    row and against ``attention_decode``'s masking math (its per-row
    ``_ring_valid_mask``); each row equals the port's own scalar call."""
    rng = np.random.default_rng(25)
    b, hq, hkv, d = len(rows), 4, 2, 16
    q, k, v = (_randn(rng, b, hq, d), _randn(rng, b, hkv, c, d),
               _randn(rng, b, hkv, c, d))
    kw = dict(scale=d ** -0.5, logit_cap=cap)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    pos = torch.tensor(rows, dtype=torch.int32)
    out = tref.decode_attention_ref(*t, pos, **kw)
    _close(out, _jax_rows(q, k, v, rows, **kw))
    valid = np.asarray(jax_attn._ring_valid_mask(jnp.asarray(rows), c))
    assert valid.shape == (b, c)
    assert valid.sum(axis=1).tolist() == [min(r + 1, c) for r in rows]
    sc = np.einsum("bkgd,bkcd->bkgc", q.reshape(b, hkv, hq // hkv, d) *
                   kw["scale"], k)
    if cap is not None:
        sc = cap * np.tanh(sc / cap)
    sc = np.where(valid[:, None, None, :], sc, jref.NEG_INF)
    pr = np.exp(sc - sc.max(-1, keepdims=True))
    pr /= pr.sum(-1, keepdims=True)
    math = np.einsum("bkgc,bkcd->bkgd", pr, v).reshape(b, hq, d)
    np.testing.assert_allclose(out.numpy(), math, atol=ATOL, rtol=0)
    for i, r in enumerate(rows):
        one = tref.decode_attention_ref(*(x[i:i + 1] for x in t), r, **kw)
        torch.testing.assert_close(out[i:i + 1], one, atol=0, rtol=0)
    # the model-layout wrapper on the CPU: the same plain version
    wrapped = tops.decode_attention(t[0][:, None], t[1].transpose(1, 2),
                                    t[2].transpose(1, 2), pos, **kw)
    torch.testing.assert_close(wrapped[:, 0], out, atol=0, rtol=0)


@pytest.mark.parametrize("cap", [None, 30.0])
@pytest.mark.parametrize("split", [16, 64])
@pytest.mark.parametrize("c,rows", PER_ROW)
def test_split_k_per_row_pos_matches_both_refs(c, rows, split, cap):
    """The ring kernel's split-K with each row at its own position, as the
    card cuts the ring (splits sized by C alone): a split may hold valid
    slots for one row and none for another, and a row at pos 0 has every
    split masked but the first one's first slot."""
    rng = np.random.default_rng(26)
    b, hq, hkv, d = len(rows), 4, 2, 16
    q, k, v = (_randn(rng, b, hq, d), _randn(rng, b, hkv, c, d),
               _randn(rng, b, hkv, c, d))
    kw = dict(scale=d ** -0.5, logit_cap=cap)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    pos = torch.tensor(rows, dtype=torch.int32)
    bounds = list(range(0, c, split)) + [c]
    out = _split_k_decode(*t, pos, bounds, **kw)
    np.testing.assert_allclose(
        out.numpy(), tref.decode_attention_ref(*t, pos, **kw).numpy(),
        atol=1e-5, rtol=0)
    _close(out, _jax_rows(q, k, v, rows, **kw), atol=1e-5)
    if 0 in rows:   # one valid slot: the row's output is v at slot 0
        i = rows.index(0)
        np.testing.assert_allclose(
            out[i].numpy(), np.repeat(v[i, :, 0], hq // hkv, axis=0),
            atol=1e-6)


def _paged_split_k(q, kp, vp, table, kt, vt, tail_len, split, *, scale,
                   logit_cap=None):
    """A plain model of the paged kernel's split-K: the (n + 1) * page
    token rows are the n table pages in order (token t < n * page is row
    t % page of slot clamp(table[t // page], 0, P - 1)), then the tail's
    page rows, valid below ``tail_len``; splits of ``split`` tokens (the
    last ragged) may straddle pages, and merge as the ring kernel's
    (:func:`_split_k_merge`). Arrays as ``paged_decode_attention_ref``'s."""
    b, hq, d = q.shape
    page, hkv = kt.shape[1], kt.shape[2]
    n = len(table)
    idx = torch.tensor(table, dtype=torch.long).clamp(0, kp.shape[0] - 1)

    def rows(pages, tail):   # (B, Hkv, (n + 1) * page, D)
        flat = pages[idx].permute(1, 0, 2, 3, 4).reshape(b, n * page, hkv, d)
        return torch.cat([flat, tail], dim=1).transpose(1, 2)

    total = (n + 1) * page
    valid = torch.arange(total) < n * page + tail_len
    bounds = list(range(0, total, split)) + [total]
    return _split_k_merge(q, rows(kp, kt), rows(vp, vt), valid, bounds,
                          scale=scale, logit_cap=logit_cap)


@pytest.mark.parametrize("g,cap", [(1, None), (2, 30.0)])
@pytest.mark.parametrize("tail_len", [0, 1, 19, 32])
@pytest.mark.parametrize("table", [
    (),                                                    # tail only
    (3,),
    (5, 1, 1, 7, 0, 3, 3, 2, 6, 4, 7, 0, 1, 5, 2, 2),      # 16, scrambled, repeated
])
@pytest.mark.parametrize("split", [16, 32, 48, 64])
def test_paged_split_k_matches_both_refs(split, table, tail_len, g, cap):
    """The paged kernel's split-K over the page table and the tail, in
    splits of 16-64 tokens over pages of 32 (48 straddles pages), at the
    tail's edges and with an empty table; fp32, 1e-5."""
    hkv, d = 2, 16
    arrays = _paged_inputs(14, 2, g * hkv, hkv, d, 32, 8)
    kw = dict(scale=d ** -0.5, logit_cap=cap)
    t = [torch.from_numpy(x) for x in arrays]
    out = _paged_split_k(t[0], t[1], t[2], table, t[3], t[4], tail_len, split,
                         **kw)
    ref = tref.paged_decode_attention_ref(
        t[0], t[1], t[2], torch.tensor(table, dtype=torch.int32), t[3], t[4],
        tail_len, **kw)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5, rtol=0)
    q, kp, vp, kt, vt = arrays
    oracle = jref.paged_decode_attention_ref(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table, jnp.int32), jnp.asarray(kt), jnp.asarray(vt),
        jnp.int32(tail_len), **kw)
    _close(out, oracle, atol=1e-5)
    if not table and tail_len == 0:
        # every row equally masked: uniform weights, the mean of v_tail
        mean = np.repeat(vt.mean(axis=1), g, axis=1)
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


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 → TF32 bit for bit as ``cvt.rna.tf32.f32``: round the magnitude
    to 10 mantissa bits, to nearest, ties away from zero (the low 13 bits
    become 0)."""
    bits = x.float().contiguous().view(torch.int32)
    sign = bits & -(2 ** 31)
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & 0x7FFFE000
    return (sign | mag).view(torch.float32)


def _split_tf32(x: torch.Tensor):
    """The kernel's hi/lo split: hi = tf32(x), lo = tf32(x - hi)."""
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x.float() - hi)


def _mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as three TF32 passes, hi.hi + hi.lo + lo.hi, summed in fp32."""
    ah, al = _split_tf32(a)
    bh, bl = _split_tf32(b)
    return ah @ bh + ah @ bl + al @ bh


def _ssd_split_model(x, a, b_mat, c_mat, chunk, sub=64):
    """A plain model of the SSD kernel's ``mma_tf32`` arithmetic, in the
    kernel's order: each chunk is walked in sub-chunks of ``sub`` rows (64
    in the kernel, the last one ragged), each with its own cumsum acs of
    a. Per sub-chunk: the inter term C.stateᵀ from the state before it
    (the state split in two, C exact), scaled by exp(acs); the score tile
    C.Bᵀ (one pass: bf16 B/C are exact in TF32; fp32 B/C, which the card
    runs on the ``fma_f32`` instance, split in three like every fp32
    operand), decayed with the upper triangle selected to 0, times X in
    three passes, source blocks of 16 rows in order; the carry
    Xᵀ.(B∘exp(acs_last − acs)) in three passes. Model layout in,
    (y (B,S,H,P), state (B,H,P,N)) fp32 out."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    split_bc = b_mat.dtype == torch.float32

    def heads(t):   # (B, S, H, .) -> (B, H, S, .) in fp32
        return t.float().transpose(1, 2)

    def mm_c(c, m):   # C . m with C exact (bf16) or split (fp32)
        if split_bc:
            return _mm3(c, m)
        mh, ml = _split_tf32(m)
        return c @ mh + c @ ml

    xs, bs, cs = heads(x), heads(b_mat), heads(c_mat)
    a_h = a.float().transpose(1, 2)                       # (B, H, S)
    state = torch.zeros(bsz, h, p, n)
    y = torch.empty(bsz, h, s, p)
    for c0 in range(0, s, chunk):
        for k0 in range(c0, c0 + chunk, sub):
            rows = slice(k0, min(k0 + sub, c0 + chunk))
            xc, bc, cc = (t[:, :, rows] for t in (xs, bs, cs))
            acs = torch.cumsum(a_h[:, :, rows], dim=-1)
            a_last = acs[..., -1:]
            ln = acs.shape[-1]
            idx = torch.arange(ln)
            causal = idx[None, :] <= idx[:, None]                # s <= l
            yc = torch.exp(acs)[..., None] * mm_c(cc, state.transpose(-1, -2))
            scores = _mm3(cc, bc.transpose(-1, -2)) if split_bc \
                else cc @ bc.transpose(-1, -2)
            seg = acs[..., :, None] - acs[..., None, :]
            lmat = torch.where(causal, scores * torch.exp(seg), 0.0)
            for s0 in range(0, ln, 16):
                yc = yc + _mm3(lmat[..., s0:s0 + 16], xc[:, :, s0:s0 + 16])
            y[:, :, rows] = yc
            bw = bc * torch.exp(a_last - acs)[..., None]
            state = state * torch.exp(a_last)[..., None] \
                + _mm3(xc.transpose(-1, -2), bw)
    return y.transpose(1, 2), state


def test_tf32_split_rounds_ties_away_and_keeps_fp32_accuracy():
    """hi keeps 10 mantissa bits (the low 13 bits 0), ties round away from
    zero, and hi + lo gives x back to 2⁻²⁰ relative or better."""
    rng = np.random.default_rng(40)
    x = torch.from_numpy(_randn(rng, 4096)
                         * np.exp2(rng.integers(-30, 30, 4096)).astype(
                             np.float32))
    hi, lo = _split_tf32(x)
    assert not bool((hi.view(torch.int32) & 0x1FFF).any())
    assert not bool((lo.view(torch.int32) & 0x1FFF).any())
    assert bool(((hi - x).abs() <= x.abs() * 2.0 ** -11).all())
    err = ((hi.double() + lo.double()) - x.double()).abs()
    assert bool((err <= x.double().abs() * 2.0 ** -20).all()), err.max()
    ties = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11,
                         1 + 2 ** -11 - 2 ** -23], dtype=torch.float32)
    assert _tf32_rna(ties).tolist() == [1 + 2 ** -10, -(1 + 2 ** -10),
                                        1 + 2 ** -9, 1.0]


@pytest.mark.parametrize("shared_bc", [False, True])
@pytest.mark.parametrize("bc_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 128, 4, 32, 16, 32),     # tests/test_kernels.py's sweep
    (1, 256, 2, 64, 32, 64),
    (2, 64, 8, 16, 8, 16),
    (1, 512, 2, 64, 64, 256),    # zamba2's P, N and chunk
    (1, 512, 2, 64, 128, 256),   # mamba2-370m's N
    (2, 200, 3, 40, 24, 100),    # ragged: sub-chunks of 64 and 36 rows
    (1, 24, 4, 32, 32, 12),      # chunk below one 16-row tile
])
def test_ssd_split_model_matches_pallas_and_refs(b, s, h, p, n, chunk,
                                                 bc_dtype, shared_bc):
    """The kernel's split arithmetic against the port's plain version, the
    JAX oracle and the Pallas kernel (interpret mode), atol 3e-5 / rtol
    1e-4; B/C in bf16 (the ``mma_tf32`` instance) and fp32, one group
    broadcast to every head (head stride 0) or one per head."""
    x, a, bm, cm = _ssd_inputs(32, b, s, h, p, n)
    if shared_bc:
        bm, cm = np.repeat(bm[:, :, :1], h, 2), np.repeat(cm[:, :, :1], h, 2)
    tb = torch.from_numpy(bm).to(bc_dtype)
    tc = torch.from_numpy(cm).to(bc_dtype)
    if shared_bc:
        tb, tc = (t[:, :, :1].expand(b, s, h, n) for t in (tb, tc))
        assert tb.stride(2) == 0
    tx, ta = torch.from_numpy(x), torch.from_numpy(a)
    y, state = _ssd_split_model(tx, ta, tb, tc, chunk)
    y_ref, state_ref = tref.ssd_scan_ref(tx, ta, tb, tc, chunk)
    _ssd_close(y, y_ref)
    _ssd_close(state, state_ref)
    # the same values in fp32 for JAX (bf16 widens exactly)
    jargs = [jnp.asarray(t.float().contiguous().numpy())
             for t in (tx, ta, tb, tc)]
    for jy, jstate in (ssd_scan_pallas(*jargs, chunk),
                       jref.ssd_scan_ref(*jargs, chunk)):
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
    assert set(ssd_scan_cuda.instances) == {"mma_tf32", "fma_f32"}
    assert set(counts) == {"flash_attention", "paged_decode_attention",
                           "decode_attention", "ssd_scan"}


def test_library_path_hashes_every_source_and_header(tmp_path, monkeypatch):
    """An edit to a shared ``.cuh`` header names a new library, so a stale
    build under ``build/kernels/`` is never loaded."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    headers = sorted(csrc.glob("*.cuh"))
    assert headers, "no shared header under csrc/"
    before = build.library_path()
    assert build.library_path() == before
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    after = build.library_path()
    assert after != before and after.parent == before.parent
