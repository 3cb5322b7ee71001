"""The port's training (``repro_torch.training``, ``optim``,
``offload.policies``, ``offload.optstate``) against the JAX package's, on
the CPU at smoke size: two-layer ``.reduced()`` configs in fp32, the JAX
parameters converted with ``repro_torch.convert``, the reference's
``SyntheticTokens`` batches.

Tolerances:

- gradients of one batch: rtol 1e-4, atol 1e-6 (the largest gap seen is
  2e-7 on gradients up to 0.4: fp32 sums over 256-512 terms in another
  order);
- AdamW and the schedule on random trees: the schedule bit for bit; fp32
  parameters and moments at rtol 1e-5, atol 1e-9 (a few ulps: the global
  norm sums in another order, its clip scales every gradient, and a
  parameter near ``lr * delta`` cancels); bf16 parameters bit for bit;
- 8 steps (``warmup=2``, ``peak_lr=1e-3``) against the JAX **resident**
  run: the loss at every step at rtol 1e-4; the parameters at the end
  within 1e-5 but for at most 0.1 % of their elements, and every element
  within 16 × ``peak_lr``. AdamW's first update is sign-like
  (``m̂/√v̂ = ±1``), so a gradient at rounding level, whose sign the two
  frameworks may draw differently, moves its parameter by ±lr either way
  (phi3: 410 of 1,312,000 elements above 1e-5, the largest 2.7e-3);
- inside the port, every remat mode and both optimizer-state placements
  equal ``none`` bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as JAX_REGISTRY
from repro.data.pipeline import SyntheticTokens as JaxTokens
from repro.models.model import build_model as jax_build_model
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import cosine_schedule as jax_cosine
from repro.training.step import TrainStepConfig as JaxTrainStepConfig
from repro.training.step import make_train_step as jax_make_train_step
from repro_torch.configs import REGISTRY
from repro_torch.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.models.model import build_model
from repro_torch.offload import optstate
from repro_torch.offload.policies import (
    OFFLOADABLE_NAMES, offload_remat_policy, remat_policy,
)
from repro_torch.optim import adamw_init, adamw_update, cosine_schedule
from repro_torch.optim.adamw import tree_items, tree_map
from repro_torch.pool.backend import is_host_resident
from repro_torch.training import TrainStepConfig, make_train_step

CPU = "cpu"
ARCHS = ["phi3-mini-3.8b", "gemma2-9b", "mamba2-370m",
         "granite-moe-3b-a800m", "minicpm3-4b"]
STEPS, SEQ, BATCH = 8, 16, 4
HP = dict(peak_lr=1e-3, warmup=2)


def two_layers(cfg):
    """The reduced config with (at least) two layers."""
    if sum(s.repeats * len(s.pattern) for s in cfg.segments) >= 2:
        return cfg
    return dataclasses.replace(cfg, segments=tuple(
        dataclasses.replace(s, repeats=2) for s in cfg.segments))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(JAX model, JAX params, port model, numpy params)."""
    arch = request.param
    jm = jax_build_model(two_layers(JAX_REGISTRY[arch].reduced()))
    tm = build_model(two_layers(REGISTRY[arch].reduced()))
    jp = jm.init(jax.random.key(0))
    return jm, jp, tm, jax.tree.map(np.asarray, jp)


@pytest.fixture(scope="module")
def phi3():
    jm = jax_build_model(two_layers(JAX_REGISTRY[ARCHS[0]].reduced()))
    tm = build_model(two_layers(REGISTRY[ARCHS[0]].reduced()))
    jp = jm.init(jax.random.key(0))
    data = JaxTokens(jm.cfg.vocab_size, seq_len=SEQ, global_batch=BATCH)
    return jm, jp, tm, jax.tree.map(np.asarray, jp), \
        [data.batch(i) for i in range(STEPS)]


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _leaves(tree):
    return [np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                       else np.asarray(x, np.float32))
            for _, x in tree_items(tree)]


def _jax_run(jm, jp, batches, **kw):
    step = jax_make_train_step(jm, JaxTrainStepConfig(**HP, **kw))
    state, params, losses = jax_adamw_init(jp), jp, []
    for b in batches:
        params, state, m = step(params, state, b)
        losses.append(float(m["loss"]))
    return losses, jax.tree.map(np.asarray, params)


def _port_run(tm, npp, batches, **kw):
    ts = TrainStepConfig(**HP, **kw)
    params = params_from_numpy(npp, CPU)
    state = adamw_init(params)
    if ts.offload_opt_state:
        state = state._replace(mu=optstate.host_offload_state(state.mu),
                               nu=optstate.host_offload_state(state.nu))
    step = make_train_step(tm, ts)
    losses = []
    for b in batches:
        params, state, m = step(params, state, _torch_batch(b))
        losses.append(float(m["loss"]))
    return losses, params, state, step


def _assert_params_close(jax_params, port_params, peak_lr):
    diffs = np.concatenate([
        np.abs(a.astype(np.float32) - b).ravel()
        for a, b in zip(_leaves(jax_params), _leaves(port_params))])
    assert diffs.max() <= 16 * peak_lr, diffs.max()
    assert int((diffs > 1e-5).sum()) <= diffs.size // 1000, \
        int((diffs > 1e-5).sum())


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------


def test_loss_and_grads_match_jax(pair):
    jm, jp, tm, npp = pair
    batch = JaxTokens(jm.cfg.vocab_size, seq_len=SEQ, global_batch=2).batch(0)
    jl, jg = jax.value_and_grad(jm.loss)(jp, batch)
    params = tree_map(lambda x: x.requires_grad_(True),
                      params_from_numpy(npp, CPU))
    loss = tm.loss(params, _torch_batch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    for a, (_, p) in zip(_leaves(jax.tree.map(np.asarray, jg)),
                         tree_items(params)):
        np.testing.assert_allclose(p.grad.numpy(), a, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", ["nothing", "everything", "dots",
                                  "save_resid", "offload"])
def test_every_remat_policy_gives_the_gradients_of_none(pair, name):
    """Bit for bit: a policy only changes what is kept, fetched or
    recomputed."""
    jm, _, tm, npp = pair
    batch = _torch_batch(JaxTokens(jm.cfg.vocab_size, seq_len=SEQ,
                                   global_batch=2).batch(1))
    policy = (offload_remat_policy(OFFLOADABLE_NAMES) if name == "offload"
              else remat_policy(name))
    grads = []
    for pol in (None, policy):
        params = tree_map(lambda x: x.requires_grad_(True),
                          params_from_numpy(npp, CPU))
        tm.loss(params, batch, remat_policy=pol).backward()
        grads.append([p.grad for _, p in tree_items(params)])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


# ---------------------------------------------------------------------------
# AdamW and the schedule
# ---------------------------------------------------------------------------


def test_cosine_schedule_equals_the_reference_bit_for_bit():
    for kw in (dict(peak_lr=3e-4, warmup=3, total=10),
               dict(peak_lr=1e-3, warmup=100, total=10_000, floor=0.2)):
        for s in (0, 1, 2, 3, 4, 7, 9, 10, 50, 100, 5000, 10_000, 20_000):
            assert float(cosine_schedule(s, **kw)) == \
                float(jax_cosine(s, **kw)), (kw, s)


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_adamw_update_matches_the_reference(dtype):
    rng = np.random.default_rng(0)
    shapes = {"embed": (7, 5), "final_norm": {"scale": (5,)},
              "segments": [{"p0": {"w": (3, 5, 4), "s": (3, 4)}}]}

    def draw(tree, scale):
        if isinstance(tree, dict):
            return {k: draw(v, scale) for k, v in tree.items()}
        if isinstance(tree, list):
            return [draw(v, scale) for v in tree]
        return (rng.standard_normal(tree) * scale).astype(dtype)

    p = draw(shapes, 1.0)
    jp, tp = jax.tree.map(jnp.asarray, p), params_from_numpy(p, CPU)
    js, ts = jax_adamw_init(jp), adamw_init(tp)
    for _ in range(3):
        g = draw(shapes, 3.0)   # global norm > 1: the clip acts
        lr = jax_cosine(js.step + 1, peak_lr=1e-2, warmup=2, total=10)
        jp, js = jax_adamw_update(jax.tree.map(jnp.asarray, g), js, jp, lr)
        tp, ts, gn = adamw_update(
            params_from_numpy(g, CPU), ts, tp,
            cosine_schedule(ts.step + 1, peak_lr=1e-2, warmup=2, total=10))
    assert int(ts.step) == int(js.step) == 3
    for a, b in zip(_leaves(jp), _leaves(tp)):
        if dtype is np.float32:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-9)
        else:
            np.testing.assert_array_equal(b, a)
    for a, b in zip(_leaves((js.mu, js.nu)), _leaves((ts.mu, ts.nu))):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-9)


# ---------------------------------------------------------------------------
# 8 steps against the JAX resident run
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_resident(phi3):
    jm, jp, _, _, batches = phi3
    return _jax_run(jm, jp, batches)


@pytest.fixture(scope="module")
def port_none(phi3):
    _, _, tm, npp, batches = phi3
    return _port_run(tm, npp, batches)


@pytest.mark.parametrize("offload_opt_state", [False, True])
@pytest.mark.parametrize("remat", ["none", "full", "offload"])
def test_training_matches_jax_resident(phi3, jax_resident, port_none, remat,
                                       offload_opt_state):
    _, _, tm, npp, batches = phi3
    losses, params, state, step = _port_run(
        tm, npp, batches, remat=remat, offload_opt_state=offload_opt_state)
    np.testing.assert_allclose(losses, jax_resident[0], rtol=1e-4)
    _assert_params_close(jax_resident[1], params, HP["peak_lr"])
    # inside the port: the memory policy changes no bit
    assert losses == port_none[0]
    assert all(torch.equal(a, b) for (_, a), (_, b)
               in zip(tree_items(params), tree_items(port_none[1])))
    assert all(torch.equal(a, b) for (_, a), (_, b)
               in zip(tree_items(state), tree_items(port_none[2])))


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "minicpm3-4b"])
def test_moe_and_mla_training_matches_jax_resident(arch):
    """8 steps of MoE (granite, the aux loss in the loss) and MLA
    (minicpm3) training against the JAX resident run, within the
    tolerances above; activation offload with the moments offloaded
    equals ``none`` bit for bit."""
    jm = jax_build_model(two_layers(JAX_REGISTRY[arch].reduced()))
    tm = build_model(two_layers(REGISTRY[arch].reduced()))
    jp = jm.init(jax.random.key(0))
    data = JaxTokens(jm.cfg.vocab_size, seq_len=SEQ, global_batch=BATCH)
    batches = [data.batch(i) for i in range(STEPS)]
    npp = jax.tree.map(np.asarray, jp)
    jl, jparams = _jax_run(jm, jp, batches)
    tl, tparams, tstate, _ = _port_run(tm, npp, batches)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    _assert_params_close(jparams, tparams, HP["peak_lr"])
    ol, oparams, ostate, _ = _port_run(tm, npp, batches, remat="offload",
                                       offload_opt_state=True)
    assert ol == tl
    assert all(torch.equal(a, b) for (_, a), (_, b)
               in zip(tree_items(oparams), tree_items(tparams)))
    assert all(torch.equal(a, b) for (_, a), (_, b)
               in zip(tree_items(ostate), tree_items(tstate)))


def test_grad_accum_matches_jax(phi3):
    jm, jp, tm, npp, batches = phi3
    jl, jparams = _jax_run(jm, jp, batches[:4], grad_accum=2)
    tl, tparams, _, _ = _port_run(tm, npp, batches[:4], grad_accum=2)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    _assert_params_close(jparams, tparams, HP["peak_lr"])


def test_training_continues_from_a_mid_run_jax_state(phi3):
    """``convert.opt_state_from_numpy`` carries a JAX ``AdamWState``
    across: four JAX steps, then four port steps from that state, against
    eight JAX steps."""
    jm, jp, tm, _, batches = phi3
    step = jax_make_train_step(jm, JaxTrainStepConfig(**HP))
    params, state = jp, jax_adamw_init(jp)
    for b in batches[:4]:
        params, state, _ = step(params, state, b)
    np_state = jax.tree.map(np.asarray, state)
    tstate = opt_state_from_numpy(np_state.step, np_state.mu, np_state.nu,
                                  CPU)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), CPU)
    tstep = make_train_step(tm, TrainStepConfig(**HP))
    for b in batches[4:]:
        tparams, tstate, _ = tstep(tparams, tstate, _torch_batch(b))
    for b in batches[4:]:
        params, state, _ = step(params, state, b)
    assert int(tstate.step) == int(state.step) == STEPS
    _assert_params_close(jax.tree.map(np.asarray, params), tparams,
                         HP["peak_lr"])


# ---------------------------------------------------------------------------
# the offload modes really park
# ---------------------------------------------------------------------------


def test_offload_modes_park_what_they_name(phi3):
    _, _, tm, npp, batches = phi3
    cfg = tm.cfg
    _, params, state, step = _port_run(tm, npp, batches[:2],
                                       remat="offload",
                                       offload_opt_state=True)
    acts, moments = step.counts["activations"], step.counts["moments"]
    layers = sum(s.repeats * len(s.pattern) for s in cfg.segments)
    per_value = BATCH * SEQ * cfg.d_model * 4
    # resid, attn_out and mlp_out of every layer, every step
    assert acts.parked == 2 * 3 * layers
    assert acts.bytes_parked == 2 * 3 * layers * per_value
    # the backward reads each layer's input and attn_out (the first
    # layer's input stays on the device)
    assert acts.bytes_fetched == 2 * (2 * layers - 1) * per_value
    n_params = sum(x.numel() for _, x in tree_items(params))
    assert moments.bytes_parked == moments.bytes_fetched \
        == 2 * 2 * 4 * n_params
    for _, m in tree_items((state.mu, state.nu)):
        assert is_host_resident(m, CPU)
        assert not any(m.data_ptr() == p.data_ptr()
                       for _, p in tree_items(params))


def test_offload_policy_refuses_unknown_names_and_kinds():
    with pytest.raises(ValueError, match="tag points"):
        offload_remat_policy(("resid", "q_proj"))
    with pytest.raises(ValueError, match="host memory kind"):
        offload_remat_policy(OFFLOADABLE_NAMES, "device")
    with pytest.raises(ValueError):
        remat_policy("sometimes")


@pytest.mark.parametrize("name", ["nothing", "save_resid", "offload"])
def test_the_recompute_takes_the_forward_attention_path(phi3, monkeypatch,
                                                        name):
    """On the card the backward (and the recompute in it) runs on
    autograd's device thread, where ``use_attention_impl("plain")`` of the
    forward is unset. Stand-in on the CPU: the path is chosen for CPU
    tensors too, the kernel path refuses inputs that require grad, and
    the backward runs on another thread."""
    import threading
    from repro_torch.kernels import ops
    from repro_torch.models import runtime
    from repro_torch.models.runtime import use_attention_impl
    _, _, tm, npp, batches = phi3

    def refuse(*args, **kw):
        raise AssertionError("the kernel path ran in training")

    monkeypatch.setattr(runtime, "attention_impl",
                        lambda device: runtime.selected_impl())
    monkeypatch.setattr(ops, "flash_attention", refuse)
    policy = (offload_remat_policy(OFFLOADABLE_NAMES) if name == "offload"
              else remat_policy(name))
    params = tree_map(lambda x: x.requires_grad_(True),
                      params_from_numpy(npp, CPU))
    with use_attention_impl("plain"):
        loss = tm.loss(params, _torch_batch(batches[0]), remat_policy=policy)
    errors = []

    def backward():
        try:
            loss.backward()
        except Exception as e:   # reported below, on the test's thread
            errors.append(e)

    worker = threading.Thread(target=backward)
    worker.start()
    worker.join(timeout=120)
    assert not worker.is_alive() and not errors, errors
    assert all(p.grad is not None for _, p in tree_items(params))
