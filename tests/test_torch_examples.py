"""The port's entry points outside the package against the reference's, on
the CPU at smoke size: ``repro_torch.launch.serve_trace`` against the
repository root's ``launch/serve.py``, and ``repro_torch.examples.*``
against ``examples/*.py``.

The reference scripts run as they are (``runpy`` with stdout captured) or
through the library calls they make; nothing in them is edited. The
reference's ``examples/quickstart.py`` aborts on XLA:CPU in its first
training step (the ``pinned_host`` moments, as ROADMAP fault 3.1), so
the quickstart's serving counts are held against the reference session's
own serving calls at the same config. Tolerances are stated per test;
counts are exact."""

import contextlib
import dataclasses
import io
import json
import re
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import HyperOffloadSession as JaxSession
from repro.api import OffloadConfig as JaxConfig
from repro.configs import REGISTRY as JAX_REGISTRY
from repro.core.costmodel import TPU_V5E as JAX_TPU_V5E
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import REGISTRY, get_config
from repro_torch.core.costmodel import H100, TPU_V5E
from repro_torch.examples import quickstart, schedule_viz, serve_offload
from repro_torch.examples import train_100m
from repro_torch.launch import serve_trace
from repro_torch.obs.check import validate_file

ROOT = Path(__file__).resolve().parents[1]
ARCH = "phi3-mini-3.8b"

#: fields of the ``serve,...`` lines read off the host clock
_CLOCK = ("wall_s", "hidden_s", "exposed_s", "hidden_fraction")
#: pool fields the host clock or the framework decides (as
#: tests/test_torch_api.py leaves out: ``bytes_fetched`` is counted on
#: the reference's transfer worker, ROADMAP fault 3.2)
_POOL_TIMING = ("bytes_fetched",)
_TRANSFER_TIMING = ("blocked_s", "backpressure_s", "waits_overlapped",
                    "waits_blocked", "backpressure_waits", "max_in_flight")


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """The port's CPU runs on one intra-op thread: its smoke-size ops are
    too small to gain from more, and the workers of a parallel test run
    share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pool_counts(pool):
    out = json.loads(json.dumps(pool, default=str))
    for k in _POOL_TIMING:
        out.pop(k)
    for k in _TRANSFER_TIMING:
        out["transfer"].pop(k)
    for pair in out["transfer"]["pairs"].values():
        pair.pop("busy_s")
    for k, v in out.items():
        if k.startswith("tier/"):
            v.pop("backend")
    return out


def _captured(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue()


# ---------------------------------------------------------------------------
# launch/serve.py
# ---------------------------------------------------------------------------


def _serve_lines(text, where):
    """The ``serve,...`` lines, split at commas, without the host-clock
    fields, the run's directory written as ``DIR``."""
    lines = []
    for line in text.replace(str(where), "DIR").splitlines():
        if line.startswith("serve,"):
            lines.append([f for f in line.split(",")
                          if f.partition(":")[0] not in _CLOCK])
    return lines


@pytest.mark.parametrize("mode", [
    ["--mode", "continuous"],
    ["--mode", "kv_offload", "--trace-out", "DIR/trace.json",
     "--stats-json", "DIR/stats.json"],
    ["--mode", "kv_offload", "--slo", "--overload", "3"],
], ids=["continuous", "kv_offload-traced", "kv_offload-slo"])
def test_serve_trace_lines_equal_the_reference(mode, tmp_path, monkeypatch):
    """Both launchers with the same flags (the port's at ``--smoke --dtype
    float32 --device cpu``): every field of every ``serve,...`` line equal
    but the host-clock ones (exact); with ``--stats-json`` the ``sched``
    counters and the pool counts equal (exact, but ``_POOL_TIMING``), the
    port's trace file valid by ``obs.check``."""
    runs = {}
    for who in ("ref", "port"):
        where = tmp_path / who
        where.mkdir()
        argv = [a.replace("DIR", str(where)) for a in mode]
        if who == "ref":
            monkeypatch.setattr(sys, "argv", ["launch/serve.py", *argv])
            _, text = _captured(lambda: runpy.run_path(
                str(ROOT / "launch" / "serve.py"), run_name="__main__"))
        else:
            res, text = _captured(lambda: serve_trace.run(
                argv + ["--smoke", "--dtype", "float32", "--device", "cpu"]))
        runs[who] = (where, text)
    ref, port = (_serve_lines(text, where) for where, text in
                 (runs["ref"], runs["port"]))
    assert port == ref
    assert res["tokens"] == res["requested_tokens"]
    if "--slo" in mode:
        assert [line[:2] for line in port] == [
            ["serve", "kv_offload"], ["serve", "slo"],
            ["serve", "slo_class"], ["serve", "slo_class"]]
    if "--stats-json" in mode:
        assert [line[:2] for line in port][1:] == [
            ["serve", "overlap"], ["serve", "stats"], ["serve", "trace"]]
        ref_stats, port_stats = (
            json.loads((where / "stats.json").read_text())
            for where, _ in (runs["ref"], runs["port"]))
        assert port_stats["sched"] == ref_stats["sched"]
        assert port_stats["sched"]["pages_parked"] > 0
        assert _pool_counts(port_stats["pool"]) == \
            _pool_counts(ref_stats["pool"])
        assert validate_file(str(runs["port"][0] / "trace.json")) == []
        assert res["overlap"]["hidden_fraction"] is not None


# ---------------------------------------------------------------------------
# examples/schedule_viz.py
# ---------------------------------------------------------------------------


def test_schedule_viz_prints_the_reference_text_under_tpu_v5e():
    """``run(hw=TPU_V5E)`` prints the reference script's text line for
    line (exact); under the port's default ``H100`` the refined order's
    peak is at most the early order's."""
    assert dataclasses.asdict(TPU_V5E) == dataclasses.asdict(JAX_TPU_V5E)
    _, ref = _captured(lambda: runpy.run_path(
        str(ROOT / "examples" / "schedule_viz.py"), run_name="__main__"))
    _, port = _captured(lambda: schedule_viz.run(hw=TPU_V5E))
    assert port.splitlines() == ref.splitlines()
    h100, text = _captured(schedule_viz.run)
    assert h100["hw"] == H100.name and "peak memory" in text
    assert h100["refined_peak_bytes"] <= h100["early_peak_bytes"]
    assert h100["refined_s"] < h100["reactive_s"]


# ---------------------------------------------------------------------------
# examples/serve_offload.py
# ---------------------------------------------------------------------------


def _jax_paged(k_ctx, v_ctx, q, k_new, v_new):
    """The reference example's calls on ``repro.offload.kvcache`` through
    the reference session, on the given arrays."""
    from repro.kernels.ref import decode_attention_ref

    b, ctx, hkv, d = k_ctx.shape
    steps = k_new.shape[0]
    scale = d ** -0.5
    page = serve_offload.PAGE
    n_pages = -(-(ctx + steps) // page)
    session = JaxSession(JaxConfig(
        mode="paged", max_seq=ctx + steps, page_size=page,
        host_capacity=2 * n_pages * b * page * hkv * d * 4))
    res = {"outputs": {}, "top_k": {}}
    with session:
        cache = session.paged_kv(batch=b, n_kv_heads=hkv, head_dim=d)
        cache.prefill(k_ctx, v_ctx)
        res.update(prefill_pages=cache.full_pages,
                   prefill_tail=cache.tail_len)
        dense = decode_attention_ref(q, k_ctx.transpose(0, 2, 1, 3),
                                     v_ctx.transpose(0, 2, 1, 3),
                                     jnp.int32(ctx - 1), scale=scale)
        res["outputs"]["all"] = cache.attend(q, scale=scale,
                                             top_k_pages=None)
        res["dense"] = dense
        for k in (8, 4, 2):
            cache.fetches = 0
            res["outputs"][f"top{k}"] = cache.attend(q, scale=scale,
                                                     top_k_pages=k)
            res["top_k"][k] = cache.fetches
        cache.attend_fused(q, scale=scale)
        res["outputs"]["fused"] = cache.attend_fused(q, scale=scale)
        res.update(buffer_hits=cache.buffer_hits,
                   buffer_misses=cache.buffer_misses)
        flushes0 = cache.flushes
        for t in range(steps):
            cache.append(k_new[t], v_new[t])
            inflight = cache.prefetch_pages(cache.select_pages(q, top_k=4))
            out = cache.attend(q, scale=scale, prefetched=inflight)
        res["outputs"]["decode_last"] = out
        res.update(decode_flushes=cache.flushes - flushes0,
                   length=cache.length, fetches=cache.fetches,
                   pool=cache.pool_stats())
    return res


def test_serve_offload_paged_demo_equals_the_reference():
    """The paged demo on numpy-drawn inputs (a 6-page context, 40 decode
    steps) against the reference's calls on the same arrays: pages,
    fetches per top-k, buffer hits and installs, flushes, cache length and
    pool counts equal (exact, but ``_POOL_TIMING``); every output within
    atol 1e-5; ``attend_fused`` equal to ``attend`` bit for bit on the
    CPU; ``attend`` over all pages within 1e-5 of the dense oracle."""
    rng = np.random.default_rng(7)
    b, ctx, hq, hkv, d, steps = 2, 200, 8, 4, 64, 40
    arrays = [rng.standard_normal(s).astype(np.float32) for s in (
        (b, ctx, hkv, d), (b, ctx, hkv, d), (b, hq, d),
        (steps, b, hkv, d), (steps, b, hkv, d))]
    port, text = _captured(lambda: serve_offload.paged_demo(
        *(torch.from_numpy(a) for a in arrays), device="cpu"))
    ref = _jax_paged(*(jnp.asarray(a) for a in arrays))
    for key in ("prefill_pages", "prefill_tail", "buffer_hits",
                "buffer_misses", "decode_flushes", "length", "fetches"):
        assert port[key] == ref[key], key
    assert {k: v["fetched"] for k, v in port["top_k"].items()} == \
        ref["top_k"] == {8: 6, 4: 4, 2: 2}
    assert port["decode_flushes"] > 0
    assert _pool_counts(port["pool"]) == _pool_counts(ref["pool"])
    assert list(port["outputs"]) == list(ref["outputs"])
    for k, out in port["outputs"].items():
        np.testing.assert_allclose(out.numpy(), np.asarray(ref["outputs"][k]),
                                   atol=1e-5, rtol=0, err_msg=k)
    assert port["fused_bitwise"] and port["fused_max_abs_diff"] == 0.0
    assert port["err_all"] <= 1e-5
    np.testing.assert_allclose(port["outputs"]["all"].numpy(),
                               np.asarray(ref["dense"]), atol=1e-5, rtol=0)
    assert "fused decode: bitwise match True" in text


_CONTINUOUS = (
    ("requests", "tokens", "steps", "joins", "retires",
     "admission_blocked"),
    r"continuous scheduler: (\d+) requests, (\d+) tokens in (\d+) steps "
    r"\(.*\) — (\d+) joins / (\d+) retires, (\d+) admission blocks",
    ("pages_parked", "cold_spills"),
    r"pages: (\d+) parked, (\d+) cold spills",
    ("fetches_issued", "layers_planned"),
    r"plan-driven prefetch: (\d+) fetches over (\d+) planned layers",
)


@pytest.mark.parametrize("slo", [False, True], ids=["fifo", "slo"])
def test_serve_offload_continuous_counts_equal_the_reference(slo):
    """``run_continuous`` against the reference's: requests, tokens,
    steps, joins, retires, admission blocks, pages parked, cold spills,
    prefetch fetches and planned layers equal (exact), with and without
    ``slo``; with it the preemption, resume and shed counts too."""
    ref_mod = runpy.run_path(str(ROOT / "examples" / "serve_offload.py"))
    _, text = _captured(lambda: ref_mod["main_continuous"](None, slo=slo))
    ref = {}
    for names, pattern in zip(_CONTINUOUS[::2], _CONTINUOUS[1::2]):
        m = re.search(pattern, text)
        assert m, (pattern, text)
        ref.update(zip(names, map(int, m.groups())))
    if slo:
        m = re.search(r"\((\d+) preemptions, (\d+) resumes, (\d+) shed\)",
                      text)
        ref.update(zip(("preemptions", "resumes", "shed"),
                       map(int, m.groups())))
    port, _ = _captured(lambda: serve_offload.run_continuous(
        slo=slo, device="cpu"))
    assert {k: port[k] for k in ref} == ref
    assert port["cold_spills"] > 0


# ---------------------------------------------------------------------------
# examples/quickstart.py
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def quickstart_run():
    return _captured(lambda: quickstart.run(device="cpu"))


def test_quickstart_trains_and_generates_identically(quickstart_run):
    """60 steps with activation and moment offload: the loss at step 59
    below step 0's; the moments in host memory; resident and
    ``kv_offload`` generation token for token equal (exact)."""
    res, text = quickstart_run
    assert list(res["losses"]) == [0, 20, 40, 59]
    assert res["losses"][59] < res["losses"][0]
    assert res["moments_device"] == "cpu"
    assert res["identical"] and "identical generations" in text
    assert tuple(res["generated"].shape) == (8, 16)


def test_quickstart_serving_counts_equal_the_reference(quickstart_run):
    """The quickstart's serve counters, round trips, pool puts, gets and
    issued fetches equal the reference session's at the same config
    driving the same two generates (exact; these counts do not depend on
    the weights or the prompt's values)."""
    res, _ = quickstart_run
    cfg = JAX_REGISTRY[ARCH].reduced()
    model = jax_build_model(cfg)
    params = model.init(jax.random.key(0))
    toks = jnp.asarray(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, 16), dtype=np.int32))
    with JaxSession(JaxConfig(mode="kv_offload", max_seq=48,
                              remat="offload",
                              offload_opt_state=True)) as session:
        session.serve_engine(model, params, offload_kv=False).generate(
            {"tokens": toks}, 16)
        engine = session.serve_engine(model, params)
        engine.generate({"tokens": toks}, 16)
        ref = session.stats()
    port = res["stats"]
    assert res["round_trips"] == engine.stats.cache_round_trips > 0
    assert port["serve"] == ref["serve"]
    for k in ("puts", "gets"):
        assert port["pool"][k] == ref["pool"][k], k
    assert port["pool"]["transfer"]["issued"] == \
        ref["pool"]["transfer"]["issued"]


# ---------------------------------------------------------------------------
# examples/train_100m.py
# ---------------------------------------------------------------------------


def test_train_100m_config_and_parameter_count_equal_the_reference():
    """``make_100m_config()`` equal to the reference's field for field, and
    the parameter count (the port's on ``meta`` tensors, the reference's
    through ``jax.eval_shape``) equal (exact)."""
    ref_mod = runpy.run_path(str(ROOT / "examples" / "train_100m.py"))
    jc, tc = ref_mod["make_100m_config"](), train_100m.make_100m_config()
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    shapes = jax.eval_shape(jax_build_model(jc).init, jax.random.key(0))
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    assert train_100m.param_count(tc) == n_ref > 60_000_000


def test_train_100m_loop_resumes_bit_for_bit(tmp_path, monkeypatch):
    """The training loop at phi3 ``.reduced()`` (100 steps, S=16, B=2):
    the checkpoint of step 100 restores the live parameters bit for bit,
    and the mean loss of the last 25 steps lies below the first 25's."""
    monkeypatch.setattr(train_100m, "make_100m_config",
                        lambda: get_config(ARCH).reduced())
    res, text = _captured(lambda: train_100m.run([
        "--steps", "100", "--seq-len", "16", "--batch", "2",
        "--ckpt-dir", str(tmp_path), "--device", "cpu"]))
    assert res["resumed_at"] == 100 and res["bitwise"] is True
    assert len(res["losses"]) == 100
    assert np.mean(res["losses"][-25:]) < np.mean(res["losses"][:25])
    assert res["params"] == train_100m.param_count(REGISTRY[ARCH].reduced())
    assert "checkpoint resume verified at step 100 (bit for bit)" in text
    assert (tmp_path / "latest.npz").is_file()


# ---------------------------------------------------------------------------
# every entry point: CUDA unless asked for the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("entry", [
    lambda: serve_trace.main(["--smoke"]),
    lambda: serve_offload.main([]),
    lambda: serve_offload.main(["--continuous"]),
    lambda: quickstart.main([]),
    lambda: train_100m.main(["--steps", "1"]),
], ids=["serve_trace", "serve_offload", "serve_offload-continuous",
        "quickstart", "train_100m"])
@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a machine without CUDA")
def test_entry_points_need_cuda_unless_asked_for_the_cpu(entry):
    """With no ``--device`` each entry point asks for CUDA, and without a
    card it raises before any work instead of running on the CPU."""
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()
