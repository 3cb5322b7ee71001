"""The port's data pipeline, checkpoints, the session's training methods
and the training launcher (``repro_torch.data``, ``checkpoint``,
``api.session``, ``launch.train``), on the CPU: a checkpoint written by
either package loads in the other, key for key and bit for bit."""

import json

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import load_checkpoint as jax_load_checkpoint
from repro.checkpoint.ckpt import save_checkpoint as jax_save_checkpoint
from repro.configs import REGISTRY as JAX_REGISTRY
from repro.data.pipeline import SyntheticTokens as JaxTokens
from repro.models.model import build_model as jax_build_model
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.api import HyperOffloadSession, OffloadConfig
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs import REGISTRY
from repro_torch.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.data import SyntheticTokens
from repro_torch.launch.train import main as train_main
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import tree_items, tree_map
from repro_torch.pool.backend import is_host_resident
from repro_torch.training import TrainStepConfig

ARCH = "phi3-mini-3.8b"
CPU = "cpu"


@pytest.fixture(scope="module")
def pair():
    """(JAX params, the port's params converted from them)."""
    jp = jax_build_model(JAX_REGISTRY[ARCH].reduced()).init(
        jax.random.key(0), jax.numpy.bfloat16)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), CPU)


def _equal(a_tree, b_tree):
    a, b = list(tree_items(a_tree)), list(tree_items(b_tree))
    return len(a) == len(b) and all(
        torch.equal(torch.from_numpy(np.array(x, np.float32)), y.float())
        for (_, x), (_, y) in zip(a, b))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_jax_checkpoint_loads_through_the_port(pair, tmp_path):
    jp, tp = pair
    path = str(tmp_path / "jax.npz")
    jax_save_checkpoint(path, jp, step=7)
    loaded, step = load_checkpoint(path, tree_map(torch.zeros_like, tp))
    assert step == 7
    assert all(a.dtype == b.dtype and torch.equal(a, b)
               for (_, a), (_, b) in zip(tree_items(loaded), tree_items(tp)))


def test_port_checkpoint_loads_through_jax(pair, tmp_path):
    jp, tp = pair
    tpath, jpath = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    save_checkpoint(tpath, tp, step=3)
    jax_save_checkpoint(jpath, jp, step=3)
    loaded, step = jax_load_checkpoint(tpath, jp)
    assert step == 3
    assert _equal(jax.tree.map(np.asarray, loaded), tp)
    # the same file and manifest as the reference writes
    with open(tpath + ".json") as f, open(jpath + ".json") as g:
        assert json.load(f) == json.load(g)
    with np.load(tpath) as a, np.load(jpath) as b:
        assert sorted(a) == sorted(b)
        assert all(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
                   for k in a)


def test_optimizer_state_checkpoint_keys_match_the_reference(pair, tmp_path):
    jp, tp = pair
    js = jax_adamw_init(jp)
    np_js = jax.tree.map(np.asarray, js)
    ts = opt_state_from_numpy(np_js.step, np_js.mu, np_js.nu, CPU)
    tpath, jpath = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    save_checkpoint(tpath, ts, step=1)
    jax_save_checkpoint(jpath, js, step=1)
    with open(tpath + ".json") as f, open(jpath + ".json") as g:
        assert json.load(f) == json.load(g)
    back, _ = load_checkpoint(jpath, ts)
    assert back.step.dtype == torch.int32
    assert all(torch.equal(a, b) for (_, a), (_, b)
               in zip(tree_items(back), tree_items(ts)))


def test_checkpoint_refuses_a_shape_mismatch_and_a_missing_leaf(pair,
                                                                tmp_path):
    _, tp = pair
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, tp)
    bad = dict(tp, embed=torch.zeros(3, 3, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="embed: shape"):
        load_checkpoint(path, bad)
    with pytest.raises(KeyError, match="extra"):
        load_checkpoint(path, dict(tp, extra=torch.zeros(1)))


# ---------------------------------------------------------------------------
# synthetic tokens
# ---------------------------------------------------------------------------


def test_synthetic_tokens_shapes_types_and_determinism():
    port = SyntheticTokens(512, seq_len=64, global_batch=4, seed=3,
                           noise=0.1)
    ref = JaxTokens(512, seq_len=64, global_batch=4, seed=3,
                    noise=0.1).batch(0)
    a, b, c = port.batch(5), port.batch(5), port.batch(6)
    for k in ("tokens", "targets"):
        assert tuple(a[k].shape) == tuple(ref[k].shape)
        assert str(a[k].dtype).split(".")[-1] == str(ref[k].dtype)
        assert torch.equal(a[k], b[k])
        assert not torch.equal(a[k], c[k])
    assert torch.equal(a["tokens"][:, 1:], a["targets"][:, :-1])
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < 512
    other_seed = SyntheticTokens(512, seq_len=64, global_batch=4, seed=4)
    assert not torch.equal(other_seed.batch(5)["tokens"], a["tokens"])


def test_synthetic_tokens_follow_the_permutation_but_for_the_noise():
    """A token not drawn as noise is the permutation of the one before it:
    the share of transitions that break the permutation is the noise share
    (less the 1/vocab a noise draw lands on the permuted token), within
    four standard deviations."""
    data = SyntheticTokens(256, seq_len=512, global_batch=8, seed=0,
                           noise=0.2)
    b = data.batch(0)
    tok, tgt = b["tokens"].long().ravel(), b["targets"].long().ravel()
    # the permutation the data follows: the most frequent successor
    counts = torch.zeros(256, 256)
    counts.index_put_((tok, tgt), torch.ones(tok.numel()), accumulate=True)
    perm = counts.argmax(dim=1)
    broken = float((perm[tok] != tgt).float().mean())
    expect = 0.2 * (1 - 1 / 256)
    sd = (expect * (1 - expect) / tok.numel()) ** 0.5
    assert abs(broken - expect) < 4 * sd + 1e-3, broken


# ---------------------------------------------------------------------------
# the session's training methods and the launcher
# ---------------------------------------------------------------------------


def test_session_training_methods_take_the_policy_from_the_config():
    model = build_model(REGISTRY[ARCH].reduced())
    cfg = OffloadConfig(remat="offload", offload_opt_state=True)
    with HyperOffloadSession(cfg, device=CPU) as s:
        ts = s.train_config(peak_lr=1e-3, warmup=2)
        assert ts == TrainStepConfig(remat="offload", offload_opt_state=True,
                                     peak_lr=1e-3, warmup=2)
        with pytest.raises(TypeError):
            s.train_step(model, ts, peak_lr=1.0)
        with pytest.raises(TypeError):
            s.init_train_state(model, ts=ts, warmup=1)
        params, opt = s.init_train_state(
            model, torch.Generator().manual_seed(0), ts=ts)
        assert params["embed"].device.type == "cpu"
        assert all(is_host_resident(m, CPU) and not m.any()
                   for _, m in tree_items((opt.mu, opt.nu)))
        step = s.train_step(model, peak_lr=1e-3, warmup=2)
        data = SyntheticTokens(model.cfg.vocab_size, seq_len=8,
                               global_batch=2)
        losses = []
        for i in range(3):
            params, opt, m = step(params, opt, data.batch(i))
            losses.append(float(m["loss"]))
        assert set(m) == {"loss", "grad_norm", "lr"}
        assert int(opt.step) == 3 and all(np.isfinite(losses))
        assert step.counts["activations"].parked > 0
        assert step.counts["moments"].bytes_parked > 0


def test_train_launcher_resumes_from_its_checkpoint(tmp_path, capsys):
    argv = ["--arch", ARCH, "--smoke", "--device", CPU, "--seq-len", "8",
            "--batch", "2", "--remat", "offload", "--offload-opt-state",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
            "--log-every", "1"]
    assert train_main(argv + ["--steps", "2"]) == 0
    first = capsys.readouterr().out
    assert "remat=offload opt_offload=True device=cpu" in first
    assert (tmp_path / "latest.npz").exists()
    assert train_main(argv + ["--steps", "3"]) == 0
    second = capsys.readouterr().out
    assert f"resumed from {tmp_path / 'latest.npz'} at step 2" in second
    assert "step     2" in second and "step     0" not in second
    assert "done: final loss" in second
