"""The PyTorch port's serving path against the JAX package's: the serving
engine (resident and the ``offload_kv`` Store/Prefetch round trip) and the
paged KV cache (gather and fused decode). Inputs come from numpy with a
seed; parameters are the JAX model's, carried across leaf by leaf."""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as JAX_REGISTRY
from repro.models.model import build_model as jax_build_model
from repro.offload.kvcache import PagedKVCache as JaxPagedKVCache
from repro.pool import default_pool as jax_default_pool
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import REGISTRY as TORCH_REGISTRY
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.paged_attention import paged_decode_attention_cuda
from repro_torch.models.model import build_model as torch_build_model
from repro_torch.obs import Tracer
from repro_torch.offload import PagedKVCache
from repro_torch.pool import default_pool
from repro_torch.serving import ServeEngine

CPU = torch.device("cpu")
ARCH = "phi3-mini-3.8b"


def _pool_counts(snap):
    """A pool snapshot without what depends on timing (measured times, how
    many transfers were in flight when waited on) or on the framework (the
    backends' names, the JAX pool's admission bookkeeping)."""
    out = {}
    for k, v in snap.items():
        if k == "reserved":
            continue
        if k == "transfer":
            v = {kk: vv for kk, vv in v.items()
                 if kk not in ("blocked_s", "backpressure_s", "pairs",
                               "waits_overlapped", "waits_blocked",
                               "backpressure_waits", "max_in_flight")}
            v["pairs"] = {p: (d["transfers"], d["bytes"])
                          for p, d in snap["transfer"]["pairs"].items()}
        elif isinstance(v, dict):
            v = {kk: vv for kk, vv in v.items() if kk != "backend"}
        out[k] = v
    return out


def test_serving_offload_kv_equals_resident_and_jax():
    jcfg, tcfg = JAX_REGISTRY[ARCH].reduced(), TORCH_REGISTRY[ARCH].reduced()
    jm, tm = jax_build_model(jcfg), torch_build_model(tcfg)
    jp = jm.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), CPU)
    toks = np.random.default_rng(0).integers(0, tcfg.vocab_size, (4, 16),
                                             dtype=np.int32)

    jax_res = JaxServeEngine(jm, jp, max_seq=32).generate(
        {"tokens": jnp.asarray(toks)}, 8)
    res = ServeEngine(tm, tp, max_seq=32).generate(
        {"tokens": torch.from_numpy(toks)}, 8)
    tracer = Tracer()
    off_engine = ServeEngine(tm, tp, max_seq=32, offload_kv=True,
                             pool=default_pool(device="cpu"), tracer=tracer)
    off = off_engine.generate({"tokens": torch.from_numpy(toks)}, 8)

    assert res.shape == (4, 8) and res.dtype == torch.int32
    np.testing.assert_array_equal(res.numpy(), np.asarray(jax_res))
    assert torch.equal(res, off)
    assert off_engine.stats.cache_round_trips == 7
    assert off_engine.stats.decoded_tokens == 4 * 7
    # real traffic went through the pool manager and its transfer engine
    pool = off_engine.pool_stats()
    assert pool["puts"] > 0 and pool["bytes_stored"] > 0
    assert pool["gets"] > 0 and pool["bytes_fetched"] > 0
    assert pool["transfer"]["issued"] > 0
    # the standing cache entries are dropped when generate returns
    assert pool["tier/host"]["entries"] == 0
    names = [e.name for e in tracer.events()]
    assert names.count("cache_round_trip") == 7 and "generate" in names


def test_hybrid_serving_offload_kv_matches_jax_tokens_and_pool_traffic():
    """zamba2 (Mamba2 + attention) through both engines, resident and
    ``offload_kv``, with a bf16 cache: the round trip carries 14 leaves in
    two dtypes (conv, k, v in bf16; the SSM state always fp32). Tokens,
    round trips and the pool's counts and bytes equal the JAX engine's."""
    arch, b, s0, new, max_seq = "zamba2-7b", 2, 12, 6, 20
    jcfg, tcfg = JAX_REGISTRY[arch].reduced(), TORCH_REGISTRY[arch].reduced()
    jm, tm = jax_build_model(jcfg), torch_build_model(tcfg)
    jp = jm.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), CPU)
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, (b, s0),
                                             dtype=np.int32)
    jpool, tpool = jax_default_pool(), default_pool(device="cpu")
    jres = JaxServeEngine(jm, jp, max_seq=max_seq,
                          cache_dtype=jnp.bfloat16).generate(
        {"tokens": jnp.asarray(toks)}, new)
    joff_engine = JaxServeEngine(jm, jp, max_seq=max_seq,
                                 cache_dtype=jnp.bfloat16, offload_kv=True,
                                 pool=jpool)
    joff = joff_engine.generate({"tokens": jnp.asarray(toks)}, new)
    res = ServeEngine(tm, tp, max_seq=max_seq,
                      cache_dtype=torch.bfloat16).generate(
        {"tokens": torch.from_numpy(toks)}, new)
    off_engine = ServeEngine(tm, tp, max_seq=max_seq,
                             cache_dtype=torch.bfloat16, offload_kv=True,
                             pool=tpool)
    buffers = {}       # pool key -> {(host buffer address, dtype)}
    put = tpool.put

    def recording_put(key, value, *args, **kwargs):
        entry = put(key, value, *args, **kwargs)
        buffers.setdefault(key, set()).add((entry.handle.data_ptr(),
                                            entry.handle.dtype))
        return entry

    tpool.put = recording_put
    off = off_engine.generate({"tokens": torch.from_numpy(toks)}, new)

    np.testing.assert_array_equal(np.asarray(jres), np.asarray(joff))
    np.testing.assert_array_equal(res.numpy(), np.asarray(jres))
    assert torch.equal(res, off)
    trips = off_engine.stats.cache_round_trips
    assert trips == joff_engine.stats.cache_round_trips == new - 1
    snap = off_engine.pool_stats()
    assert _pool_counts(snap) == _pool_counts(joff_engine.pool_stats())
    # every leaf is stored and fetched once per step, at its own dtype
    leaves = tm.init_cache(b, max_seq, torch.bfloat16, device=CPU)
    flat = [t for seg in leaves["segments"] for layer in seg.values()
            for t in layer.values()]
    assert len(flat) == 14
    assert {t.dtype for t in flat} == {torch.bfloat16, torch.float32}
    step_bytes = sum(t.numel() * t.element_size() for t in flat)
    assert snap["puts"] == snap["gets"] == 14 * trips
    assert snap["bytes_stored"] == snap["bytes_fetched"] == step_bytes * trips
    assert snap["tier/host"]["entries"] == 0
    # each key's host buffer is made once and reused at every later step
    assert len(buffers) == 14 and all(len(v) == 1 for v in buffers.values())
    assert {d for v in buffers.values() for _, d in v} == {torch.bfloat16,
                                                           torch.float32}
    tpool.close()
    jpool.close()


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "minicpm3-4b"])
def test_moe_and_mla_serving_offload_kv_matches_jax(arch):
    """MoE (granite) and MLA (minicpm3, whose cache is the 3-D latent
    ``ckv`` and ``krope`` leaves) through both engines, resident and
    ``offload_kv`` with a bf16 cache: tokens equal, and the round trip's
    pool counts and bytes equal the JAX engine's."""
    b, s0, new, max_seq = 2, 12, 6, 20
    jcfg, tcfg = JAX_REGISTRY[arch].reduced(), TORCH_REGISTRY[arch].reduced()
    jm, tm = jax_build_model(jcfg), torch_build_model(tcfg)
    jp = jm.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), CPU)
    toks = np.random.default_rng(2).integers(0, tcfg.vocab_size, (b, s0),
                                             dtype=np.int32)
    jpool, tpool = jax_default_pool(), default_pool(device="cpu")
    joff_engine = JaxServeEngine(jm, jp, max_seq=max_seq,
                                 cache_dtype=jnp.bfloat16, offload_kv=True,
                                 pool=jpool)
    joff = joff_engine.generate({"tokens": jnp.asarray(toks)}, new)
    res = ServeEngine(tm, tp, max_seq=max_seq,
                      cache_dtype=torch.bfloat16).generate(
        {"tokens": torch.from_numpy(toks)}, new)
    off_engine = ServeEngine(tm, tp, max_seq=max_seq,
                             cache_dtype=torch.bfloat16, offload_kv=True,
                             pool=tpool)
    off = off_engine.generate({"tokens": torch.from_numpy(toks)}, new)
    np.testing.assert_array_equal(res.numpy(), np.asarray(joff))
    assert torch.equal(res, off)
    assert _pool_counts(off_engine.pool_stats()) == \
        _pool_counts(joff_engine.pool_stats())
    leaves = [t for seg in tm.init_cache(b, max_seq, torch.bfloat16,
                                         device=CPU)["segments"]
              for layer in seg.values() for t in layer.values()]
    assert {t.dim() for t in leaves} == ({4} if arch.startswith("minicpm")
                                         else {5})
    tpool.close()
    jpool.close()


def test_offload_kv_frees_each_steps_cache_without_the_collector():
    """Every round trip replaces the cache; the old leaves must go as soon
    as nothing uses them, not when the garbage collector next runs (on the
    card each leaf of a full-width cache is 0.45 GB)."""
    tm = torch_build_model(TORCH_REGISTRY[ARCH].reduced())
    tp = tm.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.zeros(2, 8, dtype=torch.int32)
    leaf_shape = (1, 2, 37, tm.cfg.n_kv_heads, tm.cfg.head_dim)
    engine = ServeEngine(tm, tp, max_seq=37, offload_kv=True,
                         pool=default_pool(device="cpu"))
    gc.disable()
    try:
        engine.generate({"tokens": toks}, 12)
        # type(), not isinstance(): the latter reads __class__ of every
        # object, and some of torch's deprecated aliases warn on that
        alive = [o for o in gc.get_objects()
                 if type(o) is torch.Tensor and tuple(o.shape) == leaf_shape]
    finally:
        gc.enable()
    assert engine.stats.cache_round_trips == 11
    assert not alive, f"{len(alive)} cache leaves outlived generate()"


def test_offload_kv_needs_a_pool_on_the_parameters_device():
    tm = torch_build_model(TORCH_REGISTRY[ARCH].reduced())
    tp = tm.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="requires a pool"):
        ServeEngine(tm, tp, max_seq=8, offload_kv=True)
    with pytest.raises(ValueError, match="exceeds max_seq"):
        ServeEngine(tm, tp, max_seq=8).generate(
            {"tokens": torch.zeros(1, 6, dtype=torch.int32)}, 4)


# ---------------------------------------------------------------------------
# paged KV cache
# ---------------------------------------------------------------------------


def _filled_pair(device_pages=None, seed=0, b=2, hq=4, hkv=2, d=32, page=8,
                 s0=29):
    """The same prompt K/V in a JAX cache and a port cache."""
    rng = np.random.default_rng(seed)
    k_seq = rng.standard_normal((b, s0, hkv, d)).astype(np.float32)
    v_seq = rng.standard_normal((b, s0, hkv, d)).astype(np.float32)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    kw = dict(batch=b, max_seq=64, page_size=page, n_kv_heads=hkv,
              head_dim=d, device_pages=device_pages)
    jc = JaxPagedKVCache.create(pool=jax_default_pool(), **kw)
    jc.prefill(jnp.asarray(k_seq), jnp.asarray(v_seq))
    tc = PagedKVCache.create(pool=default_pool(device="cpu"), **kw)
    tc.prefill(torch.from_numpy(k_seq), torch.from_numpy(v_seq))
    return jc, tc, q, d ** -0.5


def test_paged_attend_fused_is_bitwise_gather_and_matches_jax():
    jc, tc, q, scale = _filled_pair()
    assert tc.full_pages == 3 and tc.tail_len == 5 and tc.flushes == 3
    tq = torch.from_numpy(q)
    before = paged_decode_attention_cuda.launches
    gather = tc.attend(tq, scale=scale)
    fused = tc.attend_fused(tq, scale=scale)
    assert torch.equal(fused, gather)
    assert tc.buffer_misses == 3 and tc.buffer_hits == 0
    fetches = tc.fetches
    assert torch.equal(tc.attend_fused(tq, scale=scale), gather)
    assert tc.buffer_hits == 3 and tc.fetches == fetches
    # the CPU runs the plain version: no kernel launch
    assert paged_decode_attention_cuda.launches == before
    jfused = jc.attend_fused(jnp.asarray(q), scale=scale)
    np.testing.assert_allclose(fused.numpy(), np.asarray(jfused), atol=2e-5,
                               rtol=0)
    # pages live in the pool's host tier, the tail on the device
    assert all(tc.pool.tier_of(k) == "host" and tc.pool.is_host_resident(k)
               for k in tc.k_pool if k is not None)


def test_paged_append_flush_sparse_selection_and_budget():
    """Appending across a page boundary flushes the page into the pool and
    the device buffer; a sparse selection under a device-page budget
    evicts LRU slots, and a selection wider than the budget raises."""
    jc, tc, q, scale = _filled_pair(device_pages=2, seed=1)
    rng = np.random.default_rng(7)
    tq = torch.from_numpy(q)
    for _ in range(3):   # 29 → 32 tokens: the fourth page flushes
        k_t = rng.standard_normal((2, 2, 32)).astype(np.float32)
        v_t = rng.standard_normal((2, 2, 32)).astype(np.float32)
        jc.append(jnp.asarray(k_t), jnp.asarray(v_t))
        tc.append(torch.from_numpy(k_t), torch.from_numpy(v_t))
    assert tc.full_pages == 4 and tc.tail_len == 0 and tc.flushes == 4
    idx = tc.select_pages(tq, top_k=2)
    np.testing.assert_array_equal(idx, jc.select_pages(jnp.asarray(q),
                                                       top_k=2))
    top2 = tc.attend_fused(tq, scale=scale, top_k_pages=2)
    assert torch.equal(top2, tc.attend(tq, scale=scale, top_k_pages=2))
    np.testing.assert_allclose(
        top2.numpy(), np.asarray(jc.attend_fused(jnp.asarray(q), scale=scale,
                                                 top_k_pages=2)),
        atol=2e-5, rtol=0)
    assert tc.buffer_misses > 0
    with pytest.raises(ValueError, match="smaller than one step's"):
        tc.attend_fused(tq, scale=scale)   # 4 pages > 2 slots


def test_paged_prefetch_pages_equals_sync_fetch():
    _, tc, q, scale = _filled_pair(seed=2)
    tq = torch.from_numpy(q)
    idx = tc.select_pages(tq, top_k=2)
    pre = tc.prefetch_pages(idx)
    assert torch.equal(tc.attend(tq, scale=scale, prefetched=pre),
                       tc.attend(tq, scale=scale, top_k_pages=2))
    empty = tc.prefetch_pages([])
    out = tc.attend(tq, scale=scale, prefetched=empty)
    assert out.shape == tq.shape and torch.isfinite(out).all()
