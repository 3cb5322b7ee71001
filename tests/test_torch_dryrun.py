"""The port's dry-run machinery (``repro_torch.launch``): the reference's
two debug-mesh tests (``tests/test_dryrun_lowering.py``), run here on a
1×1 mesh of a single-rank gloo group and held bit for bit against the
same calls outside the rules; and the production-mesh dry-run CLI on
``mamba2-370m × decode_32k``, the reference's own slow combo, which a
fake-tensor trace runs in seconds (in a subprocess: it starts the fake
process group)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import REGISTRY
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch.shardings import (
    batch_shardings,
    cache_shardings,
    param_shardings,
    place,
)
from repro_torch.models.model import build_model
from repro_torch.sharding.rules import DEFAULT_RULES, axis_rules

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def mesh():
    from repro_torch.launch.mesh import close_mesh, make_debug_mesh
    m = make_debug_mesh((1, 1), device="cpu")
    try:
        yield m
    finally:
        close_mesh()


def test_sharded_train_loss_debug_mesh(mesh):
    """phi3 ``.reduced()``: parameters and batch placed by the launch
    layer, the loss under the rules equal to the loss outside them."""
    from torch.distributed.tensor import DTensor
    cfg = REGISTRY["phi3-mini-3.8b"].reduced()
    model = build_model(cfg)
    rules = dict(DEFAULT_RULES)
    params = model.init(torch.Generator().manual_seed(0), device=CPU)
    batch = SyntheticTokens(cfg.vocab_size, 32, 4).batch(0)
    want = model.loss(params, batch)
    p = place(params, param_shardings(params, mesh, rules), mesh)
    b = place(batch, batch_shardings(batch, mesh, rules), mesh)
    assert isinstance(p["segments"][0]["p0"]["mixer"]["wq"], DTensor)
    with axis_rules(rules, mesh):
        got = model.loss(p, b)
    assert isinstance(got, DTensor)
    assert torch.equal(got.full_tensor(), want)


def test_sharded_decode_debug_mesh(mesh):
    """gemma2 ``.reduced()`` (sliding windows, softcaps, post norms):
    prefill, then decode steps at an int and a 0-dim tensor ``pos``, with
    parameters and cache placed; logits and the cache equal the run
    outside the rules bit for bit."""
    cfg = REGISTRY["gemma2-9b"].reduced()
    model = build_model(cfg)
    rules = dict(DEFAULT_RULES)
    params = model.init(torch.Generator().manual_seed(0), device=CPU)
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 12), dtype=np.int32))
    c0 = model.init_cache(2, 64, device=CPU)
    c1 = model.init_cache(2, 64, device=CPU)
    p = place(params, param_shardings(params, mesh, rules), mesh)
    dc1 = place(c1, cache_shardings(c1, mesh, rules), mesh)
    want, _ = model.prefill(params, {"tokens": tok}, c0)
    with axis_rules(rules, mesh):
        got, _ = model.prefill(p, {"tokens": tok}, dc1)
    assert torch.equal(got.full_tensor(), want)
    nxt = want.argmax(-1).to(torch.int32)
    for i, pos in enumerate((12, torch.tensor(13, dtype=torch.int32))):
        want, _ = model.decode_step(params, c0, nxt, pos)
        with axis_rules(rules, mesh):
            got, _ = model.decode_step(p, dc1, nxt, pos)
        assert torch.equal(got.full_tensor(), want), i
        nxt = want.argmax(-1).to(torch.int32)
    for leaf0, leaf1 in zip(c0["segments"][0]["p0"].values(),
                            c1["segments"][0]["p0"].values()):
        assert torch.equal(leaf0, leaf1)


def _train_under(mesh, model, batch, remat, under, backward_on_thread):
    """(loss, leaves) after two train steps of ``model`` from seed 0, its
    parameters and moments placed on ``mesh`` when ``under``; with
    ``backward_on_thread``, one loss's gradients instead, the backward run
    on another thread (inside the rule context, as a train step runs it),
    which does not see the context's variables."""
    import contextlib
    import threading
    from repro_torch.offload.policies import (OFFLOADABLE_NAMES,
                                              offload_remat_policy,
                                              remat_policy)
    from repro_torch.optim.adamw import AdamWState, tree_items, tree_map
    from repro_torch.training import (TrainStepConfig, init_train_state,
                                      make_train_step)
    rules = dict(DEFAULT_RULES)
    ts = TrainStepConfig(remat=remat, peak_lr=1e-3, warmup=1)
    params, opt = init_train_state(model, torch.Generator().manual_seed(0),
                                   torch.float32, ts, CPU)
    if under:
        params = place(params, param_shardings(params, mesh, rules), mesh)
        opt = AdamWState(opt.step, *(
            place(m, param_shardings(m, mesh, rules), mesh)
            for m in (opt.mu, opt.nu)))
    ctx = axis_rules(rules, mesh) if under else contextlib.nullcontext()

    def local(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    if not backward_on_thread:
        step = make_train_step(model, ts)
        with ctx:
            for _ in range(2):
                params, opt, m = step(params, opt, batch)
        return local(m["loss"]), [local(x) for _, x in tree_items(params)]
    policy = (offload_remat_policy(OFFLOADABLE_NAMES) if remat == "offload"
              else remat_policy("nothing"))
    params = tree_map(lambda x: x.detach().requires_grad_(True), params)
    errors = []

    def backward():
        # autograd hands its device thread the caller's thread-local
        # state (``implicit_replication`` among it), not its context
        # variables
        from torch.distributed.tensor.experimental import \
            implicit_replication
        try:
            with implicit_replication() if under \
                    else contextlib.nullcontext():
                loss.backward()
        except Exception as e:   # reported below, on the test's thread
            errors.append(e)

    with ctx:
        loss = model.loss(params, batch, remat_policy=policy)
        worker = threading.Thread(target=backward)
        worker.start()
        worker.join(timeout=120)
    assert not worker.is_alive() and not errors, errors
    return local(loss), [local(x.grad) for _, x in tree_items(params)]


@pytest.mark.parametrize("backward_on_thread", [False, True],
                         ids=["train_step", "backward_on_thread"])
@pytest.mark.parametrize("remat", ["full", "offload"])
@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "granite-moe-3b-a800m"])
def test_sharded_training_with_recompute_debug_mesh(mesh, arch, remat,
                                                    backward_on_thread):
    """Training ``.reduced()`` under the rules with a recompute in the
    backward, equal bit for bit to outside them: two train steps (losses
    and parameters), and one loss's gradients with the backward on another
    thread. On the card the backward runs on autograd's device thread,
    where the forward's context variables are unset; the thread stands in
    for it here. The recompute must re-enter the forward's rules and mesh:
    without them granite's recompute takes the local MoE path on
    ``DTensor`` weights. One intra-op thread: the CPU's parallel backward
    reductions differ run to run in the last bit, with or without a
    mesh."""
    cfg = REGISTRY[arch].reduced()
    model = build_model(cfg)
    batch = SyntheticTokens(cfg.vocab_size, 32, 4).batch(0)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = _train_under(mesh, model, batch, remat, False,
                            backward_on_thread)
        got = _train_under(mesh, model, batch, remat, True,
                           backward_on_thread)
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(got[0], want[0])
    assert len(got[1]) == len(want[1])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))


def test_kernel_wrappers_refuse_a_dtensor(mesh):
    """The wrappers take local tensors; a ``DTensor`` raises instead of
    reaching a launch (or the plain path) as a wrapper object."""
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.kernels import ops
    q = DTensor.from_local(torch.zeros(1, 4, 2, 8), mesh,
                           [Replicate(), Replicate()], run_check=False)
    with pytest.raises(TypeError):
        ops.flash_attention(q, q, q, scale=1.0)
    with pytest.raises(TypeError):
        ops.decode_attention(q[:, :1], q, q, 3, scale=1.0)


def test_production_mesh_dryrun_subprocess(tmp_path):
    """One cheap production combo through the dry-run CLI: it prints
    ``OK``, and its record carries the reference's fields, those a trace
    cannot measure null with the reason."""
    out = tmp_path / "dryrun.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun",
         "--arch", "mamba2-370m", "--shape", "decode_32k", "--out", str(out)],
        env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src")},
        capture_output=True, text=True, timeout=240, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "OK   mamba2-370m × decode_32k × 16x16" in proc.stdout
    rec, = json.loads(out.read_text())
    assert (rec["arch"], rec["shape"], rec["mesh"]) == \
        ("mamba2-370m", "decode_32k", "16x16")
    mem = rec["memory_analysis"]
    assert mem["argument_gb"] > 0
    assert mem["temp_gb"] is None and mem["peak_gb"] is None
    assert "not_measured" in mem
    assert rec["lower_s"] is None and rec["compile_s"] is None
    r = rec["roofline"]
    assert r["flops"] > 0 and r["hbm_bytes"] > 0 and r["coll_bytes"] > 0
    assert r["dominant"] in ("compute", "memory", "collective")
    assert r["peak_bytes_per_device"] == pytest.approx(mem["argument_gb"] * 1e9)
    assert set(rec["collectives"]) == {"all-reduce", "all-gather",
                                       "reduce-scatter", "all-to-all",
                                       "collective-permute"}
