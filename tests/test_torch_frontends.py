"""The port's encoder/cross-attention path (whisper-medium) and its
vision-embed/M-RoPE path (qwen2-vl-72b) against the JAX package's, on the
CPU at ``.reduced()`` size.

Parameters are the JAX model's, carried across with ``params_from_numpy``;
inputs (tokens, the frontend stubs' embeddings, vision masks and 3-plane
positions) come from numpy with a seed. The vision span's positions are a
grid whose three planes differ (temporal constant, height the row, width
the column), so a wrong M-RoPE section split shows. Tolerances, all fp32:

- M-RoPE: bit for bit against the port's own RoPE applied per section
  (the plane select is exact); against JAX at atol 1e-6 (the two
  frameworks' sin/cos differ by an ulp, 4.8e-7 at most on values of
  |x| < 5);
- ``_sinusoid``: atol 1.2e-7 x the largest position + 1e-6 (the two
  frameworks' ``exp`` differ by an ulp on some frequencies, which the
  angle multiplies by the position);
- layers, logits and caches: atol 1e-4 (matmul sums in another order);
- gradients: rtol 1e-4, atol 1e-6, as ``tests/test_torch_training.py``;
- greedy tokens, pool counts and scheduler counters: equal;
- every remat policy's gradients, the encoder's included: bit for bit
  against ``none``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sched as jsched
from repro.configs import REGISTRY as JAX_REGISTRY
from repro.models import attention as jax_attn
from repro.models import common as jax_common
from repro.models import transformer as jax_tfm
from repro.models.model import build_model as jax_build_model
from repro.pool import default_pool as jax_default_pool
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro_torch import sched as tsched
from repro_torch.api import HyperOffloadSession, OffloadConfig
from repro_torch.configs import REGISTRY as TORCH_REGISTRY
from repro_torch.convert import params_from_numpy
from repro_torch.data import SyntheticTokens
from repro_torch.models import attention as torch_attn
from repro_torch.models import common as torch_common
from repro_torch.models import transformer as torch_tfm
from repro_torch.models.model import build_model as torch_build_model
from repro_torch.models.transformer import _index
from repro_torch.offload.policies import (
    OFFLOADABLE_NAMES, offload_remat_policy, remat_policy,
)
from repro_torch.optim.adamw import tree_items, tree_map
from repro_torch.pool import default_pool
from repro_torch.serving import ServeEngine
from repro_torch.training import TrainStepConfig, make_train_step
from test_torch_sched import _lockstep

CPU = torch.device("cpu")
ATOL = 1e-4
WHISPER, VLM = "whisper-medium", "qwen2-vl-72b"


def _make_pair(arch):
    jc, tc = JAX_REGISTRY[arch].reduced(), TORCH_REGISTRY[arch].reduced()
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    jm, tm = jax_build_model(jc), torch_build_model(tc)
    jp = jm.init(jax.random.key(0))
    return jm, jp, tm, params_from_numpy(jax.tree.map(np.asarray, jp), CPU)


@pytest.fixture(scope="module")
def whisper():
    return _make_pair(WHISPER)


@pytest.fixture(scope="module")
def vlm():
    return _make_pair(VLM)


@pytest.fixture(scope="module", params=[WHISPER, VLM])
def pair(request, whisper, vlm):
    return whisper if request.param == WHISPER else vlm


def grid_positions(b, s, side):
    """(3, B, S) int32: the first side x side positions a patch grid
    (temporal 0, height the row, width the column), the rest the sequence
    index in all three planes."""
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (3, b, s)).copy()
    n = side * side
    pos[0, :, :n] = 0
    pos[1, :, :n] = np.arange(n) // side
    pos[2, :, :n] = np.arange(n) % side
    return pos


def make_batch(cfg, b, s, seed):
    """numpy model inputs: tokens and the frontend stub's entries (whisper:
    ``enc_embeds``; qwen2-vl: a 2 x 2 vision grid at the front)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s),
                                    dtype=np.int32)}
    if cfg.frontend == "audio":
        batch["enc_embeds"] = (0.1 * rng.standard_normal(
            (b, cfg.encoder.n_frames, cfg.d_model))).astype(np.float32)
    else:
        mask = np.zeros((b, s), bool)
        mask[:, :4] = True
        emb = np.zeros((b, s, cfg.d_model), np.float32)
        emb[:, :4] = 0.1 * rng.standard_normal((b, 4, cfg.d_model))
        batch.update(vision_embeds=emb, vision_mask=mask,
                     positions=grid_positions(b, s, 2))
    return batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j),
                               atol=atol, rtol=0)


def _torch_leaves(tree):
    out = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, list):
            for x in node:
                walk(x)
        else:
            out.append(node)
    walk(tree)
    return out


def _close_cache(tcache, jcache, atol=ATOL):
    jl = jax.tree.leaves(jax.tree.map(np.asarray, jcache))
    tl = _torch_leaves(tcache)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        assert tuple(t.shape) == j.shape
        _close(t, j, atol)


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d,sections", [(128, (16, 24, 24)), (32, (4, 6, 6))])
def test_mrope_selects_each_sections_plane_exactly(d, sections):
    """qwen2-vl's sections at full size and at ``.reduced()``: each
    frequency channel rotates by its own plane's position, bit for bit the
    port's RoPE over that plane; planes that are equal give RoPE itself;
    and the JAX package's ``apply_rope`` agrees."""
    rng = np.random.default_rng(d)
    x = rng.standard_normal((2, 40, 4, d)).astype(np.float32)
    pos = rng.integers(0, 600, (3, 2, 40)).astype(np.int32)
    xt, pt = torch.from_numpy(x), torch.from_numpy(pos)
    out = torch_common.apply_rope(xt, pt, 1e6, sections)
    half, lo = d // 2, 0
    for plane, n in enumerate(sections):
        ref = torch_common.apply_rope(xt, pt[plane], 1e6)
        for part in (slice(lo, lo + n), slice(half + lo, half + lo + n)):
            assert torch.equal(out[..., part], ref[..., part])
        lo += n
    same = pt[:1].expand(3, 2, 40)
    assert torch.equal(torch_common.apply_rope(xt, same, 1e6, sections),
                       torch_common.apply_rope(xt, pt[0], 1e6))
    ref = jax_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6,
                                sections)
    _close(out, ref, atol=1e-6)


def test_sinusoid_and_embed_tokens_with_a_vision_merge(whisper, vlm):
    pos = np.arange(1500, dtype=np.int32)[None]
    for d in (1024, 256):
        _close(torch_tfm._sinusoid(torch.from_numpy(pos), d),
               jax_tfm._sinusoid(jnp.asarray(pos), d),
               atol=1.2e-7 * 1499 + 1e-6)
    for jm, jp, tm, tp in (whisper, vlm):
        batch = make_batch(tm.cfg, 2, 12, seed=1)
        positions = batch.get("positions",
                              np.broadcast_to(np.arange(12), (2, 12)))
        args = (batch["tokens"], positions, batch.get("vision_embeds"),
                batch.get("vision_mask"))
        jx = jax_tfm.embed_tokens(jm.cfg, jp, *[
            None if a is None else jnp.asarray(a) for a in args])
        tx = torch_tfm.embed_tokens(tm.cfg, tp, *[
            None if a is None else torch.from_numpy(np.array(a))
            for a in args])
        _close(tx, jx, atol=1e-6)
        if tm.cfg.frontend == "vision":
            # the masked positions hold the embeddings, the rest tokens
            assert torch.equal(tx[:, :4], torch.from_numpy(
                batch["vision_embeds"][:, :4]))
            assert torch.equal(tx[:, 4:], tp["embed"][
                torch.from_numpy(batch["tokens"][:, 4:]).long()])


def test_encode_matches_jax(whisper):
    jm, jp, tm, tp = whisper
    emb = make_batch(tm.cfg, 2, 8, seed=2)["enc_embeds"]
    out = torch_tfm.encode(tm.cfg, tp, torch.from_numpy(emb))
    assert out.shape == (2, tm.cfg.encoder.n_frames, tm.cfg.d_model)
    _close(out, jax_tfm.encode(jm.cfg, jp, jnp.asarray(emb)))


def test_cross_attention_full_kv_and_decode_match_jax(whisper):
    jm, jp, tm, tp = whisper
    cfg = tm.cfg
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, cfg.encoder.n_frames,
                               cfg.d_model)).astype(np.float32)
    jl = jax.tree.map(lambda a: a[0], jp["segments"][0]["p0"]["mixer"])
    tl = _index(tp["segments"][0], 0)["p0"]["mixer"]
    _close(torch_attn.cross_attention_full(cfg, tl, torch.from_numpy(x),
                                           torch.from_numpy(enc)),
           jax_attn.cross_attention_full(jm.cfg, jl, jnp.asarray(x),
                                         jnp.asarray(enc)))
    tk, tv = torch_attn.cross_attention_kv(cfg, tl, torch.from_numpy(enc))
    jk, jv = jax_attn.cross_attention_kv(jm.cfg, jl, jnp.asarray(enc))
    _close(tk, jk)
    _close(tv, jv)
    xd = x[:, :1]
    _close(torch_attn.cross_attention_decode(cfg, tl, torch.from_numpy(xd),
                                             {"xk": tk, "xv": tv}),
           jax_attn.cross_attention_decode(jm.cfg, jl, jnp.asarray(xd),
                                           {"xk": jk, "xv": jv}))


@pytest.fixture(scope="module")
def whisper_bf16():
    """whisper at ``.reduced()`` with bf16 weights (the norms stay fp32, as
    in the reference), and the JAX run it is held against: the encoder
    output, forward logits and greedy tokens over fp32 ``enc_embeds``."""
    jc, tc = JAX_REGISTRY[WHISPER].reduced(), TORCH_REGISTRY[WHISPER].reduced()
    jm, tm = jax_build_model(jc), torch_build_model(tc)
    jp = jm.init(jax.random.key(0), jnp.bfloat16)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), CPU)
    b, s, new = 2, 8, 4
    batch = make_batch(tc, b, s, seed=11)
    ref = {"enc": np.asarray(jax_tfm.encode(jc, jp, jnp.asarray(
        batch["enc_embeds"]))),
        "logits": np.asarray(jm.forward(jp, _j(batch))[0])}
    cache = jm.init_cache(b, s + new, jnp.bfloat16)
    logits, cache = jm.prefill(jp, _j(batch), cache)
    toks = []
    for i in range(new):
        nxt = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
        toks.append(np.asarray(nxt))
        logits, cache = jm.decode_step(jp, cache, nxt,
                                       jnp.asarray(s + i, jnp.int32))
    ref["tokens"] = np.concatenate(toks, axis=1)
    return tm, tp, batch, ref


def test_bf16_whisper_encoder_runs_in_the_embeddings_type(whisper_bf16):
    """fp32 embeddings over bf16 weights run the encoder (and the cross
    keys and values made from its output) in fp32, as the reference
    promotes. Encoder output at atol 1e-4 (fp32 sums in another order; an
    encoder in bf16 misses by ~1e-2); logits at atol 2e-2 (the decoder
    runs in bf16); greedy tokens equal."""
    tm, tp, batch, ref = whisper_bf16
    enc = torch_tfm.encode(tm.cfg, tp, torch.from_numpy(batch["enc_embeds"]))
    assert enc.dtype == torch.float32
    np.testing.assert_allclose(enc.numpy(), ref["enc"], atol=1e-4, rtol=0)
    logits, _ = tm.forward(tp, _t(batch))
    np.testing.assert_allclose(logits.float().numpy(), ref["logits"],
                               atol=2e-2, rtol=0)
    b, s = batch["tokens"].shape
    new = ref["tokens"].shape[1]
    cache = tm.init_cache(b, s + new, torch.bfloat16, device=CPU)
    pb = {k: v for k, v in _t(batch).items()}
    logits, cache = tm.prefill(tp, pb, cache)
    assert cache["segments"][0]["p0"]["xk"].dtype == torch.bfloat16
    toks = []
    for i in range(new):
        nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        toks.append(nxt)
        logits, cache = tm.decode_step(tp, cache, nxt, s + i)
    np.testing.assert_array_equal(torch.cat(toks, 1).numpy(), ref["tokens"])


# ---------------------------------------------------------------------------
# the model and the serving engine
# ---------------------------------------------------------------------------


def test_forward_matches_jax_and_the_frontend_matters(pair):
    jm, jp, tm, tp = pair
    batch = make_batch(tm.cfg, 2, 12, seed=4)
    jl, _ = jm.forward(jp, _j(batch))
    tl, _ = tm.forward(tp, _t(batch))
    assert tl.shape == (2, 12, tm.cfg.padded_vocab)
    _close(tl, jl)
    # the frontend's inputs reach the logits
    key = "enc_embeds" if tm.cfg.frontend == "audio" else "vision_embeds"
    moved = dict(batch, **{key: 2.0 * batch[key]})
    assert (tm.forward(tp, _t(moved))[0] - tl).abs().max() > 1e-3


def test_prefill_and_decode_match_jax(pair):
    """Prefill (with the frontend's inputs: whisper's encoded frames land
    in every layer's ``xk``/``xv``), then decode at a scalar pos and at
    per-row (B,) pos (M-RoPE: the pos in all three planes); the logits and
    every cache leaf agree after each step."""
    jm, jp, tm, tp = pair
    b, s, max_seq = 2, 10, 16
    batch = make_batch(tm.cfg, b, s, seed=5)
    jcache, tcache = jm.init_cache(b, max_seq), tm.init_cache(b, max_seq,
                                                             device=CPU)
    jl, jcache = jm.prefill(jp, _j(batch), jcache)
    tl, tcache = tm.prefill(tp, _t(batch), tcache)
    _close(tl, jl)
    _close_cache(tcache, jcache)
    rng = np.random.default_rng(6)
    for pos in (s, np.array([s + 1, s - 3], np.int32)):
        nxt = rng.integers(0, tm.cfg.vocab_size, (b, 1), dtype=np.int32)
        jl, jcache = jm.decode_step(jp, jcache, jnp.asarray(nxt),
                                    jnp.asarray(pos, jnp.int32))
        tl, tcache = tm.decode_step(
            tp, tcache, torch.from_numpy(nxt),
            pos if isinstance(pos, int) else torch.from_numpy(pos))
        _close(tl, jl)
        _close_cache(tcache, jcache)


def test_serving_resident_and_offload_kv_match_jax(pair):
    """Greedy tokens of the port's engine, resident and ``offload_kv`` (a
    bf16 cache, whisper's cross leaves in the round trip), equal the JAX
    engine's ``offload_kv`` run, and so do the pool's counts and bytes."""
    from test_torch_serving import _pool_counts
    jm, jp, tm, tp = pair
    b, s0, new, max_seq = 2, 10, 6, 20
    batch = make_batch(tm.cfg, b, s0, seed=7)
    jpool, tpool = jax_default_pool(), default_pool(device="cpu")
    jengine = JaxServeEngine(jm, jp, max_seq=max_seq,
                             cache_dtype=jnp.bfloat16, offload_kv=True,
                             pool=jpool)
    jout = jengine.generate(_j(batch), new)
    res = ServeEngine(tm, tp, max_seq=max_seq,
                      cache_dtype=torch.bfloat16).generate(_t(batch), new)
    engine = ServeEngine(tm, tp, max_seq=max_seq, cache_dtype=torch.bfloat16,
                         offload_kv=True, pool=tpool)
    off = engine.generate(_t(batch), new)
    np.testing.assert_array_equal(res.numpy(), np.asarray(jout))
    assert torch.equal(res, off)
    assert _pool_counts(engine.pool_stats()) == \
        _pool_counts(jengine.pool_stats())
    leaves = _torch_leaves(tm.init_cache(b, max_seq, torch.bfloat16,
                                         device=CPU))
    per_trip = sum(t.numel() * t.element_size() for t in leaves)
    assert engine.pool_stats()["bytes_stored"] == per_trip * (new - 1)
    tpool.close()
    jpool.close()


@pytest.mark.parametrize("chunk", [4, 16])
def test_vlm_prefill_chunk_matches_jax(vlm, chunk):
    """qwen2-vl's text-only prompt (3-plane positions, all equal) chunk by
    chunk: logits and cache agree with JAX's after every chunk, and the
    cache left equals a whole-prompt prefill's."""
    jm, jp, tm, tp = vlm
    prompt, max_seq = 27, 32
    toks = np.random.default_rng(8).integers(0, tm.cfg.vocab_size,
                                             (1, prompt), dtype=np.int32)
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
        _close(tl, jl, atol=1e-5)
        _close_cache(tcache, jcache, atol=1e-5)
    whole = tm.init_cache(1, max_seq, device=CPU)
    wl, whole = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, whole)
    _close(tl, wl.numpy(), atol=1e-5)
    for a, b in zip(_torch_leaves(tcache), _torch_leaves(whole)):
        _close(a, b.numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# the continuous scheduler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["resident", "kv_offload", "chunk4"])
def test_vlm_scheduler_matches_the_reference_step_by_step(vlm, mode):
    """qwen2-vl through both schedulers in lockstep (text-only requests,
    as the reference builds them: positions (3, B, 1) at decode)."""
    _lockstep(vlm, mode)


def test_both_schedulers_refuse_whisper(whisper):
    """The reference's scheduler builds text-only prefill batches, so its
    first admission fails on whisper's missing ``enc_embeds``; the port
    refuses at construction."""
    jm, jp, tm, tp = whisper
    reqs = [jsched.Request(tokens=np.arange(5, dtype=np.int32),
                           max_new_tokens=3, seed=0)]
    js = jsched.ContinuousScheduler(jm, jp, jsched.SchedulerConfig(
        max_batch=2, max_seq=16))
    with pytest.raises(AssertionError):
        js.run(reqs)
    js.close()
    with pytest.raises(ValueError, match="enc_embeds"):
        tsched.ContinuousScheduler(tm, tp, tsched.SchedulerConfig(
            max_batch=2, max_seq=16))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _train_batch(tm, seed):
    batch = make_batch(tm.cfg, 2, 12, seed)
    batch["targets"] = np.roll(batch["tokens"], -1, axis=1)
    return batch


def _grads(tm, tp, batch, policy=None):
    params = tree_map(lambda x: x.detach().clone().requires_grad_(True), tp)
    loss = tm.loss(params, _t(batch), remat_policy=policy)
    loss.backward()
    return loss, [(path, p.grad) for path, p in tree_items(params)]


def test_loss_and_grads_match_jax(pair):
    jm, jp, tm, tp = pair
    batch = _train_batch(tm, seed=9)
    jl, jg = jax.value_and_grad(jm.loss)(jp, _j(batch))
    loss, grads = _grads(tm, tp, batch)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    jleaves = jax.tree.leaves(jax.tree.map(np.asarray, jg))
    assert len(jleaves) == len(grads)
    for j, (path, g) in zip(jleaves, grads):
        np.testing.assert_allclose(g.numpy(), j, rtol=1e-4, atol=1e-6,
                                   err_msg=str(path))


@pytest.mark.parametrize("name", ["nothing", "dots", "offload"])
def test_whisper_encoder_grads_under_every_policy_equal_none(whisper, name):
    """Bit for bit, the encoder's parameters included (``full`` is
    ``nothing``). The encoder output reaches each decoder layer's stage as
    an input of its own: closed over, the offload policy's stages would
    give the encoder zero gradients."""
    _, _, tm, tp = whisper
    batch = _train_batch(tm, seed=10)
    policy = (offload_remat_policy(OFFLOADABLE_NAMES) if name == "offload"
              else remat_policy(name))
    _, ref = _grads(tm, tp, batch)
    _, got = _grads(tm, tp, batch, policy)
    enc = [g for path, g in ref if path[0] == "encoder"]
    assert enc and all(bool(g.abs().sum() > 0) for g in enc)
    for (path, a), (_, b) in zip(ref, got):
        assert b is not None and torch.equal(a, b), path


def test_synthetic_tokens_carry_the_frontend_stubs(whisper, vlm):
    """``SyntheticTokens.batch(step, cfg)``: the reference's shapes and
    layout, the tokens those of the same step without ``cfg``, and the
    model trains on it."""
    for _, _, tm, tp in (whisper, vlm):
        cfg = tm.cfg
        data = SyntheticTokens(cfg.vocab_size, seq_len=16, global_batch=2)
        batch, plain = data.batch(3, cfg), data.batch(3)
        assert torch.equal(batch["tokens"], plain["tokens"])
        if cfg.frontend == "audio":
            assert batch["enc_embeds"].shape == (2, cfg.encoder.n_frames,
                                                 cfg.d_model)
        else:
            assert batch["vision_mask"].sum(1).tolist() == [2, 2]
            assert bool(batch["vision_mask"][:, :2].all())
            assert batch["vision_embeds"][:, 2:].abs().sum() == 0
            assert batch["positions"].shape == (3, 2, 16)
            assert torch.equal(batch["positions"][2, 1],
                               torch.arange(16, dtype=torch.int32))
        assert torch.isfinite(tm.loss(tp, batch))


def test_the_session_serves_schedules_and_trains_both(pair):
    """Through ``HyperOffloadSession`` (``kv_offload``): ``serve_engine``
    gives the resident engine's greedy tokens; ``scheduler`` runs
    qwen2-vl's text-only requests and refuses whisper; ``train_step``
    under ``offload`` + ``offload_opt_state`` takes the step of a plain
    ``none`` step bit for bit, on a ``SyntheticTokens`` batch with the
    frontend's inputs."""
    jm, jp, tm, tp = pair
    batch = _t(make_batch(tm.cfg, 2, 10, seed=11))
    resident = ServeEngine(tm, tp, max_seq=20).generate(batch, 5)
    conf = OffloadConfig(mode="kv_offload", max_batch=2, max_seq=20,
                         remat="offload", offload_opt_state=True)
    with HyperOffloadSession(conf, device=CPU) as sess:
        assert torch.equal(sess.serve_engine(tm, tp).generate(batch, 5),
                           resident)
        reqs = [tsched.Request(tokens=np.arange(6, dtype=np.int32) + i,
                               max_new_tokens=3, seed=i) for i in range(3)]
        if tm.cfg.frontend == "audio":
            with pytest.raises(ValueError, match="enc_embeds"):
                sess.scheduler(tm, tp)
        else:
            out = sess.scheduler(tm, tp).run(reqs)
            assert sorted(len(v) for v in out.values()) == [3, 3, 3]
        data = SyntheticTokens(tm.cfg.vocab_size, seq_len=12,
                               global_batch=2).batch(0, tm.cfg)
        hp = dict(peak_lr=1e-3, warmup=1)
        got = []
        for step, ts in ((sess.train_step(tm, **hp),
                          sess.train_config(**hp)),
                         (make_train_step(tm, TrainStepConfig(**hp)),
                          TrainStepConfig(**hp))):
            params, state = sess.init_train_state(
                tm, torch.Generator().manual_seed(0), ts=ts)
            params, _, m = step(params, state, data)
            got.append((m["loss"], [x for _, x in tree_items(params)]))
    (l0, p0), (l1, p1) = got
    assert torch.equal(l0, l1) and all(map(torch.equal, p0, p1))
