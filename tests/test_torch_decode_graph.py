"""The continuous scheduler's decode graph (``repro_torch.sched.graph``)
on the CPU: when it engages, what it counts, and that a replay serves the
eager step's tokens.

A CUDA graph exists only on the card, so the capture and replay tests
make the graph's device type the CPU's and stand in for the two CUDA
pieces: ``_warm_up`` runs the step on the current stream, and ``_record``
returns a graph whose replay runs the eager step on the static buffers
into a fixed logits buffer. The card's own tests are in
``tests/test_torch_cuda.py`` (``-k decode_graph``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import REGISTRY
from repro_torch.kernels import ops
from repro_torch.kernels.paged_attention import decode_attention_cuda
from repro_torch.models import runtime
from repro_torch.models.model import build_model
from repro_torch.pool import default_pool
from repro_torch.sched import ContinuousScheduler, Request, SchedulerConfig
from repro_torch.sched import graph as graph_mod
from repro_torch.sched.graph import DecodeGraph, capturable, same_leaves
from repro_torch.sched.scheduler import SchedClock
from repro_torch.serving.engine import jit_decode

CPU = torch.device("cpu")
B, MAX_SEQ = 3, 48


@pytest.fixture(scope="module")
def phi3():
    model = build_model(REGISTRY["phi3-mini-3.8b"].reduced())
    return model, model.init(device=CPU)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trace(vocab, seed=0):
    rng = np.random.default_rng(seed)
    shapes = [(5, 9, 0.0), (11, 4, 0.0), (3, 12, 1.0), (8, 2, 3.0),
              (6, 7, 3.0), (4, 10, 6.0), (9, 5, 9.0)]
    return [Request(tokens=rng.integers(0, vocab, size=s, dtype=np.int32),
                    max_new_tokens=n, arrival=a, seed=i,
                    temperature=0.8 if i % 3 == 1 else 0.0)
            for i, (s, n, a) in enumerate(shapes)]


def _n_attn(model):
    return sum(seg.repeats * len(seg.pattern) for seg in model.cfg.segments)


class _FakeGraph:
    def __init__(self, run):
        self._run = run
        self.replays = 0

    def replay(self):
        self.replays += 1
        self._run()


@pytest.fixture
def on_cpu(monkeypatch):
    """The graph engages on the CPU: its device type is the CPU's, the
    warm-up runs on the current stream, and a record is a stand-in whose
    replay runs ``raw`` (the step its capture saw, uncounted) on the static
    buffers. ``runtime.attention_impl`` returns the selected path, so a
    switch of it changes the key as it does on the card. Returns the
    records and the stand-in graphs made."""
    made = {"records": 0, "warm_ups": 0, "graphs": [], "raw": None}
    monkeypatch.setattr(graph_mod, "GRAPH_DEVICE", "cpu")
    monkeypatch.setattr(graph_mod.runtime, "attention_impl",
                        lambda device: runtime.selected_impl())

    def warm_up(decode, params, cache, tok, pos):
        made["warm_ups"] += 1
        logits, out = decode(params, cache, tok, pos)
        return logits, out, None

    def record(decode, params, cache, tok, pos, side):
        made["records"] += 1
        # a capture calls the step's wrappers (they count) and runs nothing
        scratch = [t.clone() for t in graph_mod._leaves(cache)]
        logits, _ = decode(params, _rebuild(cache, scratch), tok, pos)
        buf = torch.empty_like(logits)
        raw = made["raw"] or decode

        def run():
            buf.copy_(raw(params, cache, tok, pos)[0])
        g = _FakeGraph(run)
        made["graphs"].append(g)
        return g, buf

    monkeypatch.setattr(graph_mod, "_warm_up", warm_up)
    monkeypatch.setattr(graph_mod, "_record", record)
    return made


def _rebuild(tree, leaves):
    it = iter(leaves)

    def go(t):
        if isinstance(t, torch.Tensor):
            return next(it)
        if isinstance(t, dict):
            return {k: go(v) for k, v in t.items()}
        return [go(v) for v in t]
    return go(tree)


def _feed(b, pos_vals, vocab=64):
    tok = torch.arange(b, dtype=torch.int32)[:, None] % vocab
    return tok, torch.tensor(pos_vals, dtype=torch.int32)


# ---------------------------------------------------------------------------
# the engagement rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pos,engages", [
    (5, False), (torch.tensor(5), False), (torch.tensor([1, 2, 3]), True),
    (torch.zeros((3, 1), dtype=torch.int32), False)],
    ids=["int", "0-dim", "(B,)", "2-dim"])
def test_only_a_per_row_pos_on_the_graphs_device_is_capturable(
        monkeypatch, pos, engages):
    leaves = [torch.zeros(2, 3, 4)]
    tok = torch.zeros(3, 1, dtype=torch.int32)
    assert not capturable(leaves, tok, pos)       # a CPU cache, always
    monkeypatch.setattr(graph_mod, "GRAPH_DEVICE", "cpu")
    assert capturable(leaves, tok, pos) == engages
    # no leaves, or a leaf on another device
    assert not capturable([], tok, pos)
    assert not capturable(leaves + [torch.zeros(1, device="meta")], tok, pos)


def test_same_leaves_is_by_memory():
    a = [torch.zeros(4), torch.zeros(2)]
    assert same_leaves(a, list(a))
    assert same_leaves(a, [a[0][:], a[1].view(2)])
    assert not same_leaves(a, [a[0].clone(), a[1]])
    assert not same_leaves(a, a[:1])


def test_a_cpu_cache_stays_eager(phi3):
    model, params = phi3
    clock = SchedClock()
    calls = []

    def decode(*args):
        calls.append(1)
        return jit_decode(model)(*args)
    g = DecodeGraph(decode, clock)
    cache = model.init_cache(B, MAX_SEQ, device=CPU)
    tok, pos = _feed(B, [0, 1, 2])
    for p in (pos, 4, torch.tensor(4)):
        g(params, cache, tok, p)
    assert (clock.decode_captures, clock.decode_replays,
            clock.decode_eager) == (0, 0, 3)
    assert len(calls) == 3


@pytest.mark.parametrize("pos", ["int", "0-dim"])
def test_a_host_or_scalar_pos_stays_eager_on_the_graphs_device(
        phi3, on_cpu, pos):
    model, params = phi3
    clock = SchedClock()
    g = DecodeGraph(jit_decode(model), clock)
    cache = model.init_cache(B, MAX_SEQ, device=CPU)
    tok, _ = _feed(B, [0, 0, 0])
    for step in range(3):
        g(params, cache, tok, step if pos == "int" else torch.tensor(step))
    assert clock.decode_eager == 3 and on_cpu["warm_ups"] == 0
    assert on_cpu["records"] == 0


def test_a_step_that_writes_its_cache_out_of_place_stays_eager(
        phi3, on_cpu):
    """The warm-up hands back other leaves: that key runs eager from then
    on, warmed up once and never recorded; the new cache is the caller's."""
    model, params = phi3
    step = jit_decode(model)

    def out_of_place(params, cache, tok, pos):
        fresh = _rebuild(cache, [t.clone() for t in graph_mod._leaves(cache)])
        return step(params, fresh, tok, pos)
    clock = SchedClock()
    g = DecodeGraph(out_of_place, clock)
    cache = model.init_cache(B, MAX_SEQ, device=CPU)
    tok, pos = _feed(B, [0, 3, 7])
    for _ in range(4):
        _, out = g(params, cache, tok, pos)
        assert not same_leaves(list(graph_mod._leaves(cache)),
                               list(graph_mod._leaves(out)))
    assert (clock.decode_captures, clock.decode_replays,
            clock.decode_eager) == (0, 0, 4)
    assert on_cpu["warm_ups"] == 1 and on_cpu["records"] == 0


def test_a_refused_capture_stays_eager_and_counts_nothing(
        phi3, on_cpu, monkeypatch):
    model, params = phi3
    n = _n_attn(model)
    step = jit_decode(model)

    def counted(*args):
        decode_attention_cuda.launches += n
        return step(*args)

    def refuse(*args):
        counted(*args[1:5])     # a capture that fails part-way counts too
        raise RuntimeError("operation not permitted when stream is capturing")
    monkeypatch.setattr(graph_mod, "_record", refuse)
    clock = SchedClock()
    g = DecodeGraph(counted, clock)
    cache = model.init_cache(B, MAX_SEQ, device=CPU)
    tok, pos = _feed(B, [2, 0, 5])
    ops.reset_launch_counts()
    for _ in range(3):
        g(params, cache, tok, pos)
    assert clock.decode_eager == 3 and clock.decode_captures == 0
    assert ops.launch_counts()["decode_attention"] == 3 * n


# ---------------------------------------------------------------------------
# capture, replay and the key
# ---------------------------------------------------------------------------


def test_replay_equals_the_eager_step_and_counts_its_launches(phi3, on_cpu):
    """Logits of each step bit for bit against an eager twin on a copy of
    the cache; the launch counter grows by a step's launches on the
    capture's call and on every replay, as it does eager."""
    model, params = phi3
    n = _n_attn(model)
    step = jit_decode(model)
    on_cpu["raw"] = step

    def counted(*args):
        decode_attention_cuda.launches += n
        return step(*args)
    clock = SchedClock()
    g = DecodeGraph(counted, clock)
    cache = model.init_cache(B, MAX_SEQ, device=CPU)
    twin = _rebuild(cache, [t.clone() for t in graph_mod._leaves(cache)])
    ops.reset_launch_counts()
    rng = np.random.default_rng(1)
    for i in range(6):
        tok = torch.from_numpy(
            rng.integers(0, model.cfg.vocab_size, (B, 1), dtype=np.int32))
        pos = torch.tensor([i, i + 2, 0], dtype=torch.int32)
        got, out = g(params, cache, tok, pos)
        want, _ = step(params, twin, tok, pos)
        assert torch.equal(got, want)
        assert out is cache
        assert ops.launch_counts()["decode_attention"] == (i + 1) * n
    assert (clock.decode_captures, clock.decode_replays,
            clock.decode_eager) == (1, 5, 0)
    assert on_cpu["records"] == 1 and on_cpu["graphs"][0].replays == 5
    for a, b in zip(graph_mod._leaves(cache), graph_mod._leaves(twin)):
        assert torch.equal(a, b)


def test_a_new_key_never_replays_the_stale_graph(phi3, on_cpu):
    """Another attention path, or another cache, captures anew; the graph
    captured before is dropped, not replayed."""
    model, params = phi3
    clock = SchedClock()
    g = DecodeGraph(jit_decode(model), clock)
    cache = model.init_cache(B, MAX_SEQ, device=CPU)
    tok, pos = _feed(B, [1, 2, 3])
    g(params, cache, tok, pos)
    g(params, cache, tok, pos)
    first = on_cpu["graphs"][0]
    with runtime.use_attention_impl("plain"):
        g(params, cache, tok, pos)
        g(params, cache, tok, pos)
    assert first.replays == 1 and on_cpu["records"] == 2
    other = model.init_cache(B, MAX_SEQ, device=CPU)
    g(params, other, tok, pos)
    g(params, other, tok, pos)
    assert on_cpu["records"] == 3
    assert [x.replays for x in on_cpu["graphs"]] == [1, 1, 1]
    assert (clock.decode_captures, clock.decode_replays,
            clock.decode_eager) == (3, 3, 0)
    g.reset()
    assert g._captured is None


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------


def _run(model, params, kw, graph: bool, on_cpu=None):
    pool = default_pool(device=CPU) if kw.get("kv_offload") else None
    sched = ContinuousScheduler(model, params, SchedulerConfig(
        max_batch=B, max_seq=MAX_SEQ, **kw), pool=pool)
    decodes = []
    inner = sched._decode_graph.decode
    if on_cpu is not None:
        on_cpu["raw"] = inner

    def counted(*args):
        decodes.append(1)
        return inner(*args)
    sched._decode_graph.decode = counted
    if not graph:
        sched._decode = counted
    out = sched.run(_trace(model.cfg.vocab_size))
    out = [out[rid] for rid in sorted(out)]     # in the trace's order
    clock = dataclasses.replace(sched.clock)
    steps = sched.stats.steps
    sched.close()
    if pool is not None:
        pool.close()
    return out, clock, decodes, steps


@pytest.mark.parametrize("kw", [{}, {"kv_offload": True},
                                {"chunk_size": 4}],
                         ids=["resident", "kv_offload", "chunk4"])
def test_the_clock_counts_every_decode_once(phi3, kw):
    """On the CPU every batched decode runs eager, and the three counters
    add up to the decodes the scheduler made."""
    model, params = phi3
    _, clock, decodes, steps = _run(model, params, kw, graph=True)
    assert clock.decode_eager == len(decodes) > 0
    assert clock.decode_captures == clock.decode_replays == 0
    assert len(decodes) <= steps


@pytest.mark.parametrize("kw", [{}, {"kv_offload": True},
                                {"chunk_size": 4}],
                         ids=["resident", "kv_offload", "chunk4"])
def test_the_scheduler_replays_and_serves_the_eager_tokens(phi3, on_cpu, kw):
    """Rows join and retire under the graph: every request's tokens
    (greedy and sampled) equal the eager scheduler's; one capture, the
    other decodes replayed, each call counted once."""
    model, params = phi3
    eager, eclock, edecodes, _ = _run(model, params, kw, graph=False)
    got, clock, decodes, _ = _run(model, params, kw, graph=True,
                                  on_cpu=on_cpu)
    assert len(got) == len(eager) == 7
    for a, b in zip(got, eager):
        np.testing.assert_array_equal(a, b)
    n = len(edecodes)
    assert eclock.decode_eager == 0       # the eager run bypassed the graph
    assert (clock.decode_captures, clock.decode_replays,
            clock.decode_eager) == (1, n - 1, 0)
    # the warm-up and the record call the step; replays do not
    assert len(decodes) == 2
    assert on_cpu["graphs"][0].replays == n - 1


def test_the_session_reports_the_clock(phi3):
    from repro_torch.api import HyperOffloadSession, OffloadConfig
    from repro_torch.api.config import TelemetryConfig
    model, params = phi3
    s = HyperOffloadSession(OffloadConfig(
        mode="continuous", max_batch=B, max_seq=MAX_SEQ,
        telemetry=TelemetryConfig(enable=True)), device=CPU)
    sched = s.scheduler(model, params)
    sched.run(_trace(model.cfg.vocab_size))
    clock = s.stats()["sched_clock"]
    assert clock["decode_eager"] == sched.clock.decode_eager > 0
    assert clock["decode_captures"] == clock["decode_replays"] == 0
    s.close()
