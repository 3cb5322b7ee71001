"""Every architecture of the port's registry against the JAX package's, at
``.reduced()`` size on the CPU: the analog of ``tests/test_arch_smoke.py``,
with the port held against the reference instead of against itself.

Per architecture: the full forward; a prefill of all but the last token
and one decode step of it; one AdamW training step. Parameters are the
JAX model's, carried across with ``params_from_numpy``; inputs (tokens,
and the frontend stubs' entries of whisper and qwen2-vl) come from numpy
with a seed. Tolerances, fp32:

- logits of the forward, the prefill and the decode step: atol 1e-4
  (matmul sums in another order), and the greedy token of every row of
  the prefill and decode logits identical;
- the prefill + decode logits against the same package's full forward:
  atol 1e-3, the reference's own smoke test's bound;
- the training step: the loss at rtol 1e-5, the grad norm at rtol 1e-4,
  and the parameters after it within 1e-5 but for at most 0.1 % of their
  elements, every element within 2 x ``peak_lr`` (AdamW's first update is
  sign-like, ``m/sqrt(v) = ±1``: a gradient at rounding level, whose sign
  the two frameworks may draw differently, moves its parameter by ±lr
  either way).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as JAX_REGISTRY
from repro.models.model import build_model as jax_build_model
from repro.optim import adamw_init as jax_adamw_init
from repro.training.step import TrainStepConfig as JaxTrainStepConfig
from repro.training.step import make_train_step as jax_make_train_step
from repro_torch.configs import REGISTRY
from repro_torch.convert import params_from_numpy
from repro_torch.models.model import build_model
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw import tree_items
from repro_torch.training import TrainStepConfig, make_train_step

CPU = torch.device("cpu")
ARCHS = sorted(REGISTRY)
B, S = 2, 16
HP = dict(peak_lr=1e-3, warmup=1, total_steps=4)
#: batch entries along the sequence (sliced for the prefill)
SEQ_KEYS = ("tokens", "vision_embeds", "vision_mask")


def test_the_registries_hold_the_same_architectures():
    assert sorted(JAX_REGISTRY) == ARCHS


def _pair(arch):
    jm = jax_build_model(JAX_REGISTRY[arch].reduced())
    tm = build_model(REGISTRY[arch].reduced())
    jp = jm.init(jax.random.key(0))
    return jm, jp, tm, params_from_numpy(jax.tree.map(np.asarray, jp), CPU)


def make_batch(cfg, seed=1):
    """numpy inputs as ``tests/test_arch_smoke.py`` builds them: tokens as
    their own targets, whisper's ``enc_embeds``, qwen2-vl's vision
    embeddings on the first 4 positions with 3-plane positions."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    batch = {"tokens": toks, "targets": toks}
    if cfg.frontend == "audio":
        batch["enc_embeds"] = (0.1 * rng.standard_normal(
            (B, cfg.encoder.n_frames, cfg.d_model))).astype(np.float32)
    if cfg.frontend == "vision":
        batch["vision_embeds"] = (0.1 * rng.standard_normal(
            (B, S, cfg.d_model))).astype(np.float32)
        mask = np.zeros((B, S), bool)
        mask[:, :4] = True
        batch["vision_mask"] = mask
        batch["positions"] = np.broadcast_to(
            np.arange(S, dtype=np.int32), (3, B, S)).copy()
    return batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _close(t, j, atol=1e-4):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_forward_matches_jax(arch):
    jm, jp, tm, tp = _pair(arch)
    batch = make_batch(tm.cfg)
    jl, jaux = jm.forward(jp, _j(batch))
    tl, taux = tm.forward(tp, _t(batch))
    assert tl.shape == (B, S, tm.cfg.padded_vocab)
    assert bool(torch.isfinite(tl).all()) and bool(torch.isfinite(taux))
    _close(tl, jl)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_prefill_decode_matches_jax_and_the_forward(arch):
    """Prefill the first S-1 tokens (and the frontend entries), then decode
    the last one at pos S-1: both logits agree with JAX's and pick the
    same greedy token, and agree with the full forward's last two."""
    jm, jp, tm, tp = _pair(arch)
    batch = make_batch(tm.cfg)
    full, _ = tm.forward(tp, _t(batch))
    pre = {k: (v[:, :S - 1] if k in SEQ_KEYS else v)
           for k, v in batch.items() if k != "targets"}
    if "positions" in pre:
        pre["positions"] = batch["positions"][:, :, :S - 1]
    jcache, tcache = jm.init_cache(B, S), tm.init_cache(B, S, device=CPU)
    jl, jcache = jm.prefill(jp, _j(pre), jcache)
    tl, tcache = tm.prefill(tp, _t(pre), tcache)
    last = batch["tokens"][:, S - 1:]
    jd, _ = jm.decode_step(jp, jcache, jnp.asarray(last), jnp.int32(S - 1))
    td, _ = tm.decode_step(tp, tcache, torch.from_numpy(last), S - 1)
    for t, j, f in ((tl, jl, full[:, S - 2]), (td, jd, full[:, S - 1])):
        _close(t, j)
        np.testing.assert_array_equal(
            t[:, 0].argmax(-1).numpy(), np.asarray(jnp.argmax(j[:, 0], -1)))
        assert float((t[:, 0] - f).abs().max()) < 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_train_step_matches_jax(arch):
    jm, jp, tm, tp = _pair(arch)
    batch = make_batch(tm.cfg)
    jstep = jax_make_train_step(jm, JaxTrainStepConfig(**HP))
    jparams, _, jmet = jstep(jp, jax_adamw_init(jp), _j(batch))
    step = make_train_step(tm, TrainStepConfig(**HP))
    before = [x.clone() for _, x in tree_items(tp)]
    params, _, met = step(tp, adamw_init(tp), _t(batch))
    assert bool(torch.isfinite(met["loss"])) and float(met["grad_norm"]) > 0
    np.testing.assert_allclose(met["loss"].item(), float(jmet["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(met["grad_norm"].item(),
                               float(jmet["grad_norm"]), rtol=1e-4)
    after = [x for _, x in tree_items(params)]
    assert any(not torch.equal(a, b) for a, b in zip(before, after))
    diffs = np.concatenate([
        np.abs(np.asarray(j, np.float32) - t.numpy()).ravel()
        for j, t in zip(jax.tree.leaves(jax.tree.map(np.asarray, jparams)),
                        after)])
    assert diffs.max() <= 2 * HP["peak_lr"], diffs.max()
    assert int((diffs > 1e-5).sum()) <= diffs.size // 1000, \
        int((diffs > 1e-5).sum())
