"""The PyTorch port's model against the JAX package's, at smoke size.

The JAX model's parameters are carried across with ``params_from_numpy``
(the port keeps the stacked per-segment layout), inputs come from numpy
with a seed, and the JAX side runs its ``"xla"`` path. Tolerance: 1e-4 in
fp32 — the two frameworks order their matmul sums differently.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as JAX_REGISTRY
from repro.configs.base import LayerSpec as JaxLayerSpec
from repro.configs.base import Segment as JaxSegment
from repro.models import attention as jax_attn
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import REGISTRY as TORCH_REGISTRY
from repro_torch.configs.base import LayerSpec as TorchLayerSpec
from repro_torch.configs.base import Segment as TorchSegment
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops as torch_kops
from repro_torch.models import attention as torch_attn
from repro_torch.models import runtime as torch_runtime
from repro_torch.models.model import build_model as torch_build_model

ATOL = 1e-4
CPU = torch.device("cpu")


def _windowed(cfg, layer_spec, segment, window):
    """gemma2's local/global pattern with a window shorter than the test
    sequences, so the ring caches wrap."""
    local = layer_spec(mixer="attn", ffn="swiglu", window=window,
                       post_norms=True)
    glob = layer_spec(mixer="attn", ffn="swiglu", post_norms=True)
    return dataclasses.replace(
        cfg, segments=(segment(pattern=(local, glob), repeats=2),))


def _configs(name):
    """(JAX config, port config) built the same way from each package."""
    if name == "gemma2-windowed":
        return (_windowed(JAX_REGISTRY["gemma2-9b"].reduced(), JaxLayerSpec,
                          JaxSegment, 6),
                _windowed(TORCH_REGISTRY["gemma2-9b"].reduced(),
                          TorchLayerSpec, TorchSegment, 6))
    arch, kv = {"phi3": ("phi3-mini-3.8b", None),
                "gemma2": ("gemma2-9b", None),
                "phi3-gqa": ("phi3-mini-3.8b", 2),
                "mamba2": ("mamba2-370m", None),
                "zamba2": ("zamba2-7b", None)}[name]
    jc, tc = JAX_REGISTRY[arch].reduced(), TORCH_REGISTRY[arch].reduced()
    if kv is not None:
        jc = dataclasses.replace(jc, n_kv_heads=kv)
        tc = dataclasses.replace(tc, n_kv_heads=kv)
    return jc, tc


CONFIGS = ["phi3", "gemma2", "phi3-gqa", "gemma2-windowed", "mamba2",
           "zamba2"]


def _pair(name, seed=0):
    jc, tc = _configs(name)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    jm, tm = jax_build_model(jc), torch_build_model(tc)
    jp = jm.init(jax.random.key(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), CPU)
    return jm, jp, tm, tp


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s),
                                                dtype=np.int32)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol,
                               rtol=0)


def _close_cache(tcache, jcache, atol=ATOL):
    t_leaves = jax.tree.leaves(jax.tree.map(np.asarray, jcache))
    flat = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, list):
            for x in node:
                walk(x)
        else:
            flat.append(node)

    walk(tcache)
    assert len(flat) == len(t_leaves)
    for t, j in zip(flat, t_leaves):
        assert tuple(t.shape) == j.shape
        _close(t, j, atol)


def test_convert_copies_and_reads_bfloat16_bits():
    jm, _, _, _ = _pair("phi3")
    jp = jm.init(jax.random.key(1), jnp.bfloat16)
    tree = jax.tree.map(np.asarray, jp)
    tp = params_from_numpy(tree, CPU)
    wq = tp["segments"][0]["p0"]["mixer"]["wq"]
    assert wq.dtype == torch.bfloat16
    ref = np.asarray(jp["segments"][0]["p0"]["mixer"]["wq"]).astype(np.float32)
    np.testing.assert_array_equal(wq.float().numpy(), ref)
    # a copy: writing the tensor leaves the source array alone
    wq.zero_()
    assert np.any(tree["segments"][0]["p0"]["mixer"]["wq"] != 0)
    # norm scales stay fp32, as the reference keeps them
    assert tp["final_norm"]["scale"].dtype == torch.float32
    as32 = params_from_numpy(tree, CPU, dtype=torch.float32)
    assert as32["embed"].dtype == torch.float32


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_matches_jax(name):
    jm, jp, tm, tp = _pair(name)
    toks = _tokens(tm.cfg, 2, 12, seed=1)
    jl, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    tl, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert tl.shape == (2, 12, tm.cfg.padded_vocab)
    _close(tl, jl)


@pytest.mark.parametrize("name", CONFIGS)
def test_prefill_and_decode_match_jax(name):
    """Prefill, then decode at a scalar pos and at per-row (B,) pos; the
    logits and every cache leaf agree after each step."""
    jm, jp, tm, tp = _pair(name)
    b, s, max_seq = 2, 10, 16
    toks = _tokens(tm.cfg, b, s, seed=2)
    jcache = jm.init_cache(b, max_seq)
    tcache = tm.init_cache(b, max_seq, device=CPU)
    jl, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jcache)
    tl, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcache)
    _close(tl, jl)
    _close_cache(tcache, jcache)

    nxt = _tokens(tm.cfg, b, 1, seed=3)
    jl, jcache = jm.decode_step(jp, jcache, jnp.asarray(nxt), jnp.int32(s))
    tl, tcache = tm.decode_step(tp, tcache, torch.from_numpy(nxt), s)
    _close(tl, jl)
    _close_cache(tcache, jcache)

    # continuous batching: each row writes its own index
    pos = np.array([s + 1, s - 3], np.int32)
    nxt = _tokens(tm.cfg, b, 1, seed=4)
    jl, jcache = jm.decode_step(jp, jcache, jnp.asarray(nxt), jnp.asarray(pos))
    tl, tcache = tm.decode_step(tp, tcache, torch.from_numpy(nxt),
                                torch.from_numpy(pos))
    _close(tl, jl)
    _close_cache(tcache, jcache)


@pytest.mark.parametrize("name", CONFIGS)
def test_greedy_tokens_match_jax(name):
    """16 greedy steps pick the same tokens. Each step's top-2 logit margin
    must exceed 1e-3, so a near-tie fails loudly instead of flaking."""
    jm, jp, tm, tp = _pair(name)
    b, s, steps = 2, 8, 16
    toks = _tokens(tm.cfg, b, s, seed=5)
    jcache = jm.init_cache(b, s + steps)
    tcache = tm.init_cache(b, s + steps, device=CPU)
    jl, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jcache)
    tl, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcache)
    jdecode = jax.jit(jm.decode_step)
    for i in range(steps):
        top2 = torch.topk(tl[:, 0], 2, dim=-1).values
        assert float((top2[:, 0] - top2[:, 1]).min()) > 1e-3, f"near-tie at {i}"
        jt = np.asarray(jnp.argmax(jl[:, 0], axis=-1)).astype(np.int32)
        tt = torch.argmax(tl[:, 0], dim=-1).to(torch.int32)
        np.testing.assert_array_equal(tt.numpy(), jt)
        if i == steps - 1:
            break
        jl, jcache = jdecode(jp, jcache, jnp.asarray(jt)[:, None],
                             jnp.int32(s + i))
        tl, tcache = tm.decode_step(tp, tcache, tt[:, None], s + i)


# ---------------------------------------------------------------------------
# attention_decode routed through ops.decode_attention (the ring kernel)
# ---------------------------------------------------------------------------

# (config, layer of the segment's pattern, ring capacity): phi3's full
# cache, phi3 with G = 2, gemma2's capped global layer, and gemma2's capped
# local layer whose window-6 ring wraps every 6 tokens
ROUTED = {"phi3": ("phi3", 0, 16), "phi3-gqa": ("phi3-gqa", 0, 16),
          "gemma2-global": ("gemma2", 1, 16),
          "gemma2-local": ("gemma2-windowed", 0, 6)}


@pytest.fixture
def routed_decode(monkeypatch):
    """``attention_impl`` says "kernel" on the CPU too, and
    ``ops.decode_attention`` (on the CPU: the plain ring version) counts
    its calls."""
    calls = []
    real = torch_kops.decode_attention

    def counting(*args, **kwargs):
        calls.append(args[3])
        return real(*args, **kwargs)

    monkeypatch.setattr(torch_runtime, "attention_impl", lambda dev: "kernel")
    monkeypatch.setattr(torch_kops, "decode_attention", counting)
    return calls


def _decode_layer(name, seed):
    cfg_name, layer, c = ROUTED[name]
    jc, tc = _configs(cfg_name)
    jm = jax_build_model(jc)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))
    jlayer = jax.tree.map(lambda a: a[0], jp["segments"][0][f"p{layer}"])
    spec_j = jc.segments[0].pattern[layer]
    spec_t = tc.segments[0].pattern[layer]
    rng = np.random.default_rng(seed)
    b = 2
    cache = {n: rng.standard_normal((b, c, tc.n_kv_heads, tc.head_dim))
             .astype(np.float32) for n in ("k", "v")}
    assert torch_attn.attn_cache_len(tc, spec_t, 16) == c
    return (jc, spec_j, jlayer["mixer"], tc, spec_t,
            params_from_numpy(jlayer["mixer"], CPU), cache, rng)


def _decode_both(name, pos, tpos, seed=11):
    """One decode step of one attention layer, JAX at ``pos`` and the port
    at ``tpos`` (the same index, as an int or a tensor)."""
    jc, spec_j, jp, tc, spec_t, tp, cache, rng = _decode_layer(name, seed)
    b = cache["k"].shape[0]
    x = rng.standard_normal((b, 1, tc.d_model)).astype(np.float32)
    jpos = jnp.asarray(pos, jnp.int32)
    positions = np.broadcast_to(np.asarray(pos, np.int32).reshape(-1, 1),
                                (b, 1)).copy()
    jout, jcache = jax_attn.attention_decode(
        jc, spec_j, jp, jnp.asarray(x), jpos, jnp.asarray(positions),
        {n: jnp.asarray(a) for n, a in cache.items()})
    tcache = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    tout, tcache = torch_attn.attention_decode(
        tc, spec_t, tp, torch.from_numpy(x), tpos,
        torch.from_numpy(positions), tcache)
    _close(tout, jout)
    for n in ("k", "v"):
        _close(tcache[n], jcache[n])


@pytest.mark.parametrize("step", [-1, 0, 1, 5, 6, 7, 11, 12, 20])
@pytest.mark.parametrize("name", list(ROUTED))
def test_routed_decode_matches_jax_across_the_ring_wrap(routed_decode, name,
                                                        step):
    """An int ``pos`` under "kernel" goes through ``ops.decode_attention``
    on the cache just written, with the layer's scale and cap, and matches
    JAX's ``attention_decode`` at positions around each wrap of the ring."""
    c = ROUTED[name][2]
    pos = c + step
    _decode_both(name, pos, pos)
    assert routed_decode == [pos]


@pytest.mark.parametrize("name", list(ROUTED))
def test_per_row_pos_keeps_the_plain_decode(routed_decode, name):
    """A (B,) pos (rows at their own indices) and a 0-dim tensor pos under
    "kernel" go through ``ops.decode_attention`` too, handed over as
    tensors, and match JAX's ``attention_decode``: the plain decode is
    left only under ``"plain"``."""
    c = ROUTED[name][2]
    rows = np.array([c + 3, c - 2], np.int32)
    _decode_both(name, rows, torch.from_numpy(rows))
    _decode_both(name, c + 1, torch.tensor(c + 1, dtype=torch.int32))
    _decode_both(name, np.array([0, c - 1], np.int32),
                 torch.tensor([0, c - 1], dtype=torch.int32))
    assert len(routed_decode) == 3
    assert all(isinstance(p, torch.Tensor) for p in routed_decode)
    assert routed_decode[0].tolist() == rows.tolist()
    assert int(routed_decode[1]) == c + 1
    assert routed_decode[2].tolist() == [0, c - 1]


# ---------------------------------------------------------------------------
# chunked prefill
# ---------------------------------------------------------------------------

CHUNK_ATOL = 1e-5


@pytest.mark.parametrize("chunk", [4, 16, 32])
@pytest.mark.parametrize("name", ["phi3", "gemma2", "gemma2-windowed"])
def test_prefill_chunk_matches_jax(name, chunk):
    """A 27-token prompt prefilled chunk by chunk into a 32-slot cache: the
    last valid token's logits and every cache leaf agree with JAX's
    ``prefill_chunk`` after each chunk (fp32, atol 1e-5). The last chunk is
    padded at every chunk size; gemma2-windowed's window-6 local layer
    wraps its 6-slot ring inside chunks of 4 and holds only the last 6 of a
    chunk of 16 or 32. The cache left at the end equals a whole-prompt
    ``prefill``'s."""
    jm, jp, tm, tp = _pair(name)
    prompt, max_seq = 27, 32
    toks = _tokens(tm.cfg, 1, prompt, seed=12)
    jcache = jm.init_cache(1, max_seq)
    tcache = tm.init_cache(1, max_seq, device=CPU)
    for off in range(0, prompt, chunk):
        valid = min(chunk, prompt - off)
        t = np.zeros((1, chunk), np.int32)
        t[0, :valid] = toks[0, off:off + valid]
        jl, jcache = jm.prefill_chunk(jp, {"tokens": jnp.asarray(t)},
                                      jnp.int32(off), jnp.int32(valid),
                                      jcache)
        tl, tcache = tm.prefill_chunk(tp, {"tokens": torch.from_numpy(t)},
                                      off, valid, tcache)
        assert tl.shape == (1, 1, tm.cfg.padded_vocab)
        _close(tl, jl, atol=CHUNK_ATOL)
        _close_cache(tcache, jcache, atol=CHUNK_ATOL)
    whole = tm.init_cache(1, max_seq, device=CPU)
    wl, whole = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, whole)
    _close(tl, wl.numpy(), atol=CHUNK_ATOL)
    _close_cache(tcache, jax.tree.map(np.asarray, _as_jax_tree(whole)),
                 atol=CHUNK_ATOL)


def _as_jax_tree(tcache):
    """A port cache as the nested dict/list of numpy arrays JAX flattens in
    the same (sorted-key) order."""
    if isinstance(tcache, dict):
        return {k: _as_jax_tree(v) for k, v in tcache.items()}
    if isinstance(tcache, list):
        return [_as_jax_tree(v) for v in tcache]
    return tcache.numpy()


@pytest.mark.parametrize("offset", [3, 5, 6, 11])
def test_prefill_chunk_at_a_ring_wrapping_offset_matches_jax(offset):
    """gemma2-windowed's window-6 ring entered mid-window: one chunk of 8
    with 7 valid tokens at offsets where the chunk wraps the ring, over a
    cache holding the tokens before it (written by a first chunk)."""
    jm, jp, tm, tp = _pair("gemma2-windowed", seed=1)
    toks = _tokens(tm.cfg, 1, offset + 7, seed=13)
    jcache = jm.init_cache(1, 32)
    tcache = tm.init_cache(1, 32, device=CPU)
    first = np.zeros((1, 16), np.int32)
    first[0, :offset] = toks[0, :offset]
    jl, jcache = jm.prefill_chunk(jp, {"tokens": jnp.asarray(first)},
                                  jnp.int32(0), jnp.int32(offset), jcache)
    tl, tcache = tm.prefill_chunk(tp, {"tokens": torch.from_numpy(first)},
                                  0, offset, tcache)
    _close(tl, jl, atol=CHUNK_ATOL)
    t = np.zeros((1, 8), np.int32)
    t[0, :7] = toks[0, offset:offset + 7]
    jl, jcache = jm.prefill_chunk(jp, {"tokens": jnp.asarray(t)},
                                  jnp.int32(offset), jnp.int32(7), jcache)
    tl, tcache = tm.prefill_chunk(tp, {"tokens": torch.from_numpy(t)},
                                  offset, 7, tcache)
    _close(tl, jl, atol=CHUNK_ATOL)
    _close_cache(tcache, jcache, atol=CHUNK_ATOL)


def test_ring_write_at_drops_padding_and_keeps_the_tail():
    buf = torch.zeros(1, 6, 1)
    vals = torch.arange(1.0, 11.0).reshape(1, 10, 1)
    jbuf = jax_attn._ring_write_at(jnp.zeros((1, 6, 1)), jnp.asarray(vals),
                                   jnp.int32(4), jnp.int32(9))
    torch_attn._ring_write_at(buf, vals, 4, 9)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    # valid tokens 4..12 (values 1..9); the last 6, tokens 7..12 (values
    # 4..9), land at slots t % 6; the padded 10th value is never written
    assert buf[0, :, 0].tolist() == [9.0, 4.0, 5.0, 6.0, 7.0, 8.0]


def test_cache_specs_allocate_nothing_and_match_init_cache():
    _, _, tm, _ = _pair("gemma2-windowed")
    specs = tm.cache_specs(2, 32, torch.bfloat16)
    real = tm.init_cache(2, 32, torch.bfloat16, device=CPU)
    flat_s, flat_r = [], []
    for tree, out in ((specs, flat_s), (real, flat_r)):
        for seg in tree["segments"]:
            for layer in seg.values():
                out.extend(layer[k] for k in sorted(layer))
    assert [t.device.type for t in flat_s] == ["meta"] * len(flat_r)
    assert [(t.shape, t.dtype) for t in flat_s] == \
        [(t.shape, t.dtype) for t in flat_r]
    assert tm.supports_chunked_prefill()
    assert not _pair("mamba2")[2].supports_chunked_prefill()
