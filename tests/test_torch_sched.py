"""The port's continuous scheduler (``repro_torch.sched``) against the JAX
package's (``repro.sched``), at smoke size on the CPU.

Both packages get the same parameters (the JAX model's, carried across
with ``params_from_numpy``) and the same requests (from numpy with a
seed). The two schedulers are stepped in lockstep over the reference's
mixed trace (staggered arrivals, mixed lengths, 5 requests over 2 slots),
resident and ``kv_offload``, whole-prompt and chunked, and every step must
emit the same greedy tokens and leave the same counters: ``SchedStats``,
the pool's deterministic counts (reservations included), the prefetcher's
fetches and the latency histograms. Greedy decoding only: sampled tokens
come from ``torch.Generator`` in the port and ``jax.random`` in the
reference.
"""

import dataclasses
import re

import jax
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as JAX_REGISTRY
from repro.core.costmodel import TPU_V5E as JAX_TPU_V5E
from repro.models.model import build_model as jax_build_model
from repro.obs.metrics import MetricsRegistry as JaxMetrics
from repro.offload.kvcache import worst_case_page_bytes as jax_row_bytes
from repro.pool import TransferEngine as JaxTransferEngine
from repro.pool import default_pool as jax_default_pool
from repro import sched as jsched
from repro.slo.policy import SLOConfig as JaxSLOConfig
from repro_torch import sched as tsched
from repro_torch.configs import REGISTRY as TORCH_REGISTRY
from repro_torch.convert import params_from_numpy
from repro_torch.core.costmodel import TPU_V5E as TORCH_TPU_V5E
from repro_torch.models.model import build_model as torch_build_model
from repro_torch.obs.metrics import STEP_BUCKETS
from repro_torch.obs.metrics import MetricsRegistry as TorchMetrics
from repro_torch.offload.kvcache import worst_case_page_bytes as torch_row_bytes
from repro_torch.pool import default_pool as torch_default_pool
from repro_torch.serving.engine import ServeEngine
from repro_torch.slo.policy import SLOConfig as TorchSLOConfig

CPU = torch.device("cpu")
MAX_SEQ = 32
ARCHS = {"phi3": "phi3-mini-3.8b", "gemma2": "gemma2-9b"}


@pytest.fixture(scope="module", params=sorted(ARCHS))
def pair(request):
    """(JAX model, JAX params, port model, port params) of one reduced
    config, the port's parameters converted from the JAX model's."""
    arch = ARCHS[request.param]
    jm = jax_build_model(JAX_REGISTRY[arch].reduced())
    tm = torch_build_model(TORCH_REGISTRY[arch].reduced())
    jp = jm.init(jax.random.key(0))
    return jm, jp, tm, params_from_numpy(jax.tree.map(np.asarray, jp), CPU)


def _mixed_trace(pkg, vocab):
    """``tests/test_sched.py``'s mixed trace, built with ``pkg.Request``:
    staggered arrivals + mixed lengths on a 2-slot batch force mid-stream
    joins, retirements and continuous slot reuse."""
    rng = np.random.default_rng(0)
    shapes = [(5, 6, 0.0), (9, 3, 0.0), (3, 8, 2.0), (7, 1, 4.0), (4, 5, 4.0)]
    return [pkg.Request(tokens=rng.integers(0, vocab, size=s, dtype=np.int32),
                        max_new_tokens=n, arrival=a, seed=i)
            for i, (s, n, a) in enumerate(shapes)]


# ---------------------------------------------------------------------------
# poisson_trace, ArrivalQueue, AdmissionController
# ---------------------------------------------------------------------------


def _trace_fields(reqs):
    return [(r.tokens.tobytes(), r.tokens.dtype.str, r.max_new_tokens,
             r.arrival, r.temperature, r.top_k, r.seed,
             None if r.slo is None else dataclasses.astuple(r.slo))
            for r in reqs]


TRACE_MODES = {
    "plain": {},
    "quantum": dict(prompt_lens=(5, 30), prompt_quantum=4),
    "long-tail": dict(long_prompt_lens=(40, 64), long_fraction=0.3,
                      prompt_quantum=8),
    "interactive": dict(interactive_fraction=0.5),
    "prefix": dict(n_prefix_families=3, prefix_len=6),
}


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("mode", sorted(TRACE_MODES))
def test_poisson_trace_is_byte_identical(mode, seed):
    kw = dict(rate=0.7, vocab_size=512, seed=seed, **TRACE_MODES[mode])
    jt, tt = jsched.poisson_trace(24, **kw), tsched.poisson_trace(24, **kw)
    assert _trace_fields(tt) == _trace_fields(jt)
    if mode == "interactive":
        assert {r.slo.priority_class for r in tt} == {"interactive", "batch"}


def test_poisson_trace_refuses_what_the_reference_refuses():
    for kw in (dict(prompt_lens=(5, 7), prompt_quantum=8),
               dict(interactive_fraction=1.5),
               dict(n_prefix_families=0, prefix_len=4)):
        with pytest.raises(ValueError) as je:
            jsched.poisson_trace(4, rate=1.0, vocab_size=64, **kw)
        with pytest.raises(ValueError) as te:
            tsched.poisson_trace(4, rate=1.0, vocab_size=64, **kw)
        assert str(te.value) == str(je.value)


def test_arrival_queue_and_admission_behave_alike():
    """One trace, submitted out of order into each package's queue and
    admitted against a capacity-bounded pool: the same heads, ready sets,
    admissions, refusals and reservations at every tick."""
    kw = dict(rate=1.5, vocab_size=512, seed=3)
    jt, tt = jsched.poisson_trace(12, **kw), tsched.poisson_trace(12, **kw)
    order = np.random.default_rng(4).permutation(len(jt))
    jq, tq = jsched.ArrivalQueue(), tsched.ArrivalQueue()
    for i in order:
        jq.push(jt[i])
        tq.push(tt[i])
    seeds = lambda states: [s.request.seed for s in states]   # noqa: E731
    assert seeds(tq.pending()) == seeds(jq.pending())
    row = 3000
    jpool = jax_default_pool(device_capacity=2 * row, host_capacity=3 * row)
    tpool = torch_default_pool(device_capacity=2 * row, host_capacity=3 * row,
                               device="cpu")
    ja, ta = (jsched.AdmissionController(jpool, itemsize=4),
              tsched.AdmissionController(tpool, itemsize=4))
    assert ta.tiers == ja.tiers
    assert ta.can_ever_admit(5 * row) == ja.can_ever_admit(5 * row) is True
    assert ta.can_ever_admit(5 * row + 1) == ja.can_ever_admit(5 * row + 1)
    admitted_j, admitted_t = [], []
    now = 0.0
    while len(jq):
        assert len(tq) == len(jq)
        assert tq.next_arrival() == jq.next_arrival()
        assert seeds(tq.ready(now)) == seeds(jq.ready(now))
        jh, th = jq.head_ready(now), tq.head_ready(now)
        assert (jh is None) == (th is None)
        if jh is not None:
            nbytes = row + 100 * jh.request.seed
            ok_j, ok_t = ja.try_admit(jh, nbytes), ta.try_admit(th, nbytes)
            assert ok_t == ok_j
            if ok_j:
                admitted_j.append(jq.pop())
                admitted_t.append(tq.pop())
            elif admitted_j:   # a retirement frees capacity
                ja.release(admitted_j.pop(0))
                ta.release(admitted_t.pop(0))
        assert ta.blocked == ja.blocked
        assert tpool.reserved_bytes() == jpool.reserved_bytes()
        assert tpool.headroom(ta.tiers, 4) == jpool.headroom(ja.tiers, 4)
        now += 0.5
    assert ta.blocked > 0
    jpool.close()
    tpool.close()


# ---------------------------------------------------------------------------
# the scheduler, in lockstep with the reference
# ---------------------------------------------------------------------------


def _det_counts(snap):
    """A pool snapshot's counts that the main thread alone sets (puts,
    spills, drops, occupancy, reservations, transfers issued): equal after
    every step. Fetch counts move on the transfer workers and are compared
    once every fetch has been waited on."""
    out = {k: snap[k] for k in ("puts", "evictions", "drops", "bytes_stored",
                                "bytes_evicted", "reserved")}
    out["issued"] = snap["transfer"]["issued"]
    for k, v in snap.items():
        if k.startswith("tier/"):
            out[k] = {kk: vv for kk, vv in v.items() if kk != "backend"}
    return out


def _pool_counts(snap):
    """A pool snapshot without what depends on timing (measured times, how
    many transfers were in flight when waited on) or on the framework (the
    backends' names)."""
    out = {}
    for k, v in snap.items():
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


#: the scheduler's latency histograms and their buckets
HISTOGRAMS = {"req_ttft_steps": STEP_BUCKETS,
              "req_queue_wait_steps": STEP_BUCKETS,
              "req_time_per_output_token_steps": (0.25, 0.5, 1, 2, 4, 8, 16,
                                                  32)}

MODES = {
    "resident": {},
    "kv_offload": dict(kv_offload=True),
    # device tier of 1.5 rows: cold sequences' pages spill to the host tier
    "kv_offload-spill": dict(kv_offload=True),
    "chunk4": dict(chunk_size=4),
    "chunk16": dict(chunk_size=16),
    f"chunk{MAX_SEQ}": dict(chunk_size=MAX_SEQ),
    "chunk4-budget8": dict(chunk_size=4, prefill_tokens=8),
    "chunk4-kv_offload": dict(chunk_size=4, kv_offload=True),
}


def _pools(mode, jm, tm):
    if "kv_offload" not in mode:
        return None, None
    if mode.endswith("spill"):
        row = jax_row_bytes(jm.cache_specs(1, MAX_SEQ, np.float32))
        assert torch_row_bytes(tm.cache_specs(1, MAX_SEQ,
                                              torch.float32)) == row
        caps = dict(device_capacity=int(1.5 * row), host_capacity=4 * row)
        return (jax_default_pool(transfer=JaxTransferEngine(depth=64),
                                 **caps),
                torch_default_pool(transfer_depth=64, device="cpu", **caps))
    return jax_default_pool(), torch_default_pool(device="cpu")


@pytest.mark.parametrize("mode", sorted(MODES))
def test_scheduler_matches_the_reference_step_by_step(pair, mode):
    jm, jp, tm, tp = pair
    jpool, tpool = _pools(mode, jm, tm)
    kw = dict(max_batch=2, max_seq=MAX_SEQ, **MODES[mode])
    jmet, tmet = JaxMetrics(), TorchMetrics()
    js = jsched.ContinuousScheduler(
        jm, jp, jsched.SchedulerConfig(hw=JAX_TPU_V5E, **kw), pool=jpool,
        metrics=jmet)
    ts = tsched.ContinuousScheduler(
        tm, tp, tsched.SchedulerConfig(hw=TORCH_TPU_V5E, **kw), pool=tpool,
        metrics=tmet)
    jreqs = _mixed_trace(jsched, tm.cfg.vocab_size)
    treqs = _mixed_trace(tsched, tm.cfg.vocab_size)
    ids = {t.req_id: j.req_id for j, t in zip(jreqs, treqs)}
    for j, t in zip(jreqs, treqs):
        js.submit(j)
        ts.submit(t)
    assert ts.default_max_steps() == js.default_max_steps()
    while len(js.queue) or js.active:
        assert len(ts.queue) == len(js.queue)
        assert [s.req_id for s in js.slots if s] == \
            [ids[s.req_id] for s in ts.slots if s]
        if not js.active and js.queue.head_ready(js.now) is None:
            js.now = max(js.now, js.queue.next_arrival())
            ts.now = max(ts.now, ts.queue.next_arrival())
        je, te = js.step(), ts.step()
        assert [(ids[r], t) for r, t in te] == je
        assert dataclasses.asdict(ts.stats) == dataclasses.asdict(js.stats)
        assert _det_counts(ts.pool_stats()) == _det_counts(js.pool_stats())
    assert not ts.active and not len(ts.queue)
    jout = {r.seed: js.finished[r.req_id].tokens_array() for r in jreqs}
    tout = {r.seed: ts.finished[r.req_id].tokens_array() for r in treqs}
    assert tout.keys() == jout.keys()
    for seed in jout:
        np.testing.assert_array_equal(tout[seed], jout[seed])
    assert ts.stats.decoded_tokens == sum(r.max_new_tokens - 1 for r in treqs)
    assert ts.stats.prefill_tokens == sum(r.prompt_len for r in treqs)
    assert ts.prefetch_stats() == js.prefetch_stats()
    if "kv_offload" in mode:
        assert ts.prefetch_stats()["fetches_issued"] > 0
        assert ts.stats.pages_parked > 0
    assert ts.stats.cold_spills == js.stats.cold_spills
    if mode.endswith("spill"):
        assert ts.stats.cold_spills > 0
    assert _pool_counts(ts.pool_stats()) == _pool_counts(js.pool_stats())
    for name, buckets in HISTOGRAMS.items():
        assert tmet.histogram(name, buckets).snapshot() == \
            jmet.histogram(name, buckets).snapshot()
    assert tmet.histogram("req_ttft_steps", STEP_BUCKETS).count == len(treqs)
    assert tmet.render_prometheus() == jmet.render_prometheus()
    ts.close()
    js.close()
    if tpool is not None:
        assert tpool.snapshot()["reserved"] == 0
        assert tpool.snapshot()["tier/device"]["entries"] == 0
        tpool.close()
        jpool.close()


def test_run_matches_sequential_serving_and_resident(pair):
    """``run`` gives, per request, what the port's batch-1 ``ServeEngine``
    gives, in both modes."""
    _, _, tm, tp = pair
    reqs = _mixed_trace(tsched, tm.cfg.vocab_size)
    eng = ServeEngine(tm, tp, max_seq=MAX_SEQ)
    ref = {r.req_id: eng.generate({"tokens": torch.from_numpy(r.tokens)[None]},
                                  r.max_new_tokens)[0].numpy()
           for r in reqs}
    pool = torch_default_pool(device="cpu")
    for cfg_kw, p in (({}, None), (dict(kv_offload=True), pool)):
        sched = tsched.ContinuousScheduler(
            tm, tp, tsched.SchedulerConfig(max_batch=2, max_seq=MAX_SEQ,
                                           **cfg_kw), pool=p)
        reqs = _mixed_trace(tsched, tm.cfg.vocab_size)
        out = sched.run(reqs)
        for r, want in zip(reqs, ref.values()):
            np.testing.assert_array_equal(out[r.req_id], want)
        sched.close()
        sched.close()   # idempotent
    pool.close()


def test_temperature_sampling_matches_batch1_engine(pair):
    """At temperature > 0 each request draws from its own generator,
    seeded with its seed: the stream a batch-1 ``ServeEngine.generate``
    with that seed draws from."""
    _, _, tm, tp = pair
    rng = np.random.default_rng(3)
    reqs = [tsched.Request(tokens=rng.integers(0, tm.cfg.vocab_size, size=s,
                                               dtype=np.int32),
                           max_new_tokens=4, temperature=0.8, top_k=8, seed=i)
            for i, s in enumerate((5, 8))]
    sched = tsched.ContinuousScheduler(
        tm, tp, tsched.SchedulerConfig(max_batch=2, max_seq=MAX_SEQ))
    out = sched.run(reqs)
    eng = ServeEngine(tm, tp, max_seq=MAX_SEQ)
    for r in reqs:
        want = eng.generate({"tokens": torch.from_numpy(r.tokens)[None]},
                            r.max_new_tokens, temperature=0.8, top_k=8,
                            seed=r.seed)[0].numpy()
        np.testing.assert_array_equal(out[r.req_id], want)
    sched.close()


def test_replan_swaps_the_plan_and_keeps_the_counters(pair):
    _, _, tm, tp = pair
    pool = torch_default_pool(device="cpu")
    cache = {}
    sched = tsched.ContinuousScheduler(
        tm, tp, tsched.SchedulerConfig(max_batch=2, max_seq=MAX_SEQ,
                                       kv_offload=True),
        pool=pool, plan_cache=cache)
    assert sched.cfg.hw.name == "h100_sxm"
    reqs = _mixed_trace(tsched, tm.cfg.vocab_size)
    for r in reqs[:2]:
        sched.submit(r)
    for _ in range(3):
        sched.step()
    issued = sched.prefetch_stats()["fetches_issued"]
    sched.replan(TORCH_TPU_V5E)
    assert sched.cfg.hw is TORCH_TPU_V5E and len(cache) == 2
    assert sched.prefetch_stats()["fetches_issued"] == issued
    sched.run(reqs[2:])
    assert sched.stats.retires == len(reqs)
    sched.close()
    pool.close()


# ---------------------------------------------------------------------------
# errors
# ---------------------------------------------------------------------------


def _errors(pkg, model, params):
    """(type, message) of each refused construction or submission."""
    out = {}
    cases = {
        "chunk_size": dict(chunk_size=MAX_SEQ + 1),
        "prefill_tokens-without-chunk": dict(prefill_tokens=8),
        "prefill_tokens-zero": dict(chunk_size=4, prefill_tokens=0),
        "kv_offload-without-pool": dict(kv_offload=True),
    }
    for name, kw in cases.items():
        with pytest.raises(ValueError) as e:
            pkg.ContinuousScheduler(
                model, params,
                pkg.SchedulerConfig(max_batch=2, max_seq=MAX_SEQ, **kw))
        out[name] = str(e.value)
    sched = pkg.ContinuousScheduler(
        model, params, pkg.SchedulerConfig(max_batch=2, max_seq=MAX_SEQ))
    with pytest.raises(ValueError) as e:
        sched.submit(pkg.Request(tokens=np.zeros(30, np.int32),
                                 max_new_tokens=3))
    out["oversized"] = re.sub(r"request \d+", "request N", str(e.value))
    sched.close()
    return out


def test_scheduler_errors_match_the_reference():
    jm, tm = (jax_build_model(JAX_REGISTRY["phi3-mini-3.8b"].reduced()),
              torch_build_model(TORCH_REGISTRY["phi3-mini-3.8b"].reduced()))
    jp = jm.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), CPU)
    je, te = _errors(jsched, jm, jp), _errors(tsched, tm, tp)
    assert te.keys() == je.keys()
    for name in je:
        if name == "kv_offload-without-pool":   # each names its own pool
            assert "requires a pool" in te[name] and "requires a pool" in je[name]
        else:
            assert te[name] == je[name], name
    # recurrent mixers cannot resume a chunk: both refuse mamba2
    jmm = jax_build_model(JAX_REGISTRY["mamba2-370m"].reduced())
    tmm = torch_build_model(TORCH_REGISTRY["mamba2-370m"].reduced())
    jmp = jmm.init(jax.random.key(0))
    tmp = params_from_numpy(jax.tree.map(np.asarray, jmp), CPU)
    assert not tmm.supports_chunked_prefill()
    assert tm.supports_chunked_prefill()
    msgs = []
    for pkg, m, p in ((jsched, jmm, jmp), (tsched, tmm, tmp)):
        with pytest.raises(ValueError) as e:
            pkg.ContinuousScheduler(m, p, pkg.SchedulerConfig(
                max_batch=2, max_seq=MAX_SEQ, chunk_size=4))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "recurrent" in msgs[1]
    # neither can ever admit a request larger than its pool
    for pkg, m, p, make_pool in (
            (jsched, jm, jp, lambda: jax_default_pool(device_capacity=10,
                                                      host_capacity=10)),
            (tsched, tm, tp, lambda: torch_default_pool(
                device_capacity=10, host_capacity=10, device="cpu"))):
        pool = make_pool()
        sched = pkg.ContinuousScheduler(
            m, p, pkg.SchedulerConfig(max_batch=2, max_seq=MAX_SEQ,
                                      kv_offload=True), pool=pool)
        with pytest.raises(RuntimeError, match="can never be admitted"):
            sched.run(_mixed_trace(pkg, 512)[:1])
        sched.close()
        pool.close()


def test_slo_and_prefix_cache_are_refused_until_ported():
    tm = torch_build_model(TORCH_REGISTRY["phi3-mini-3.8b"].reduced())
    tp = tm.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match=r"slo/admission\.py"):
        tsched.ContinuousScheduler(tm, tp, tsched.SchedulerConfig(
            max_batch=2, max_seq=MAX_SEQ, slo=TorchSLOConfig(enable=True)))
    with pytest.raises(ValueError, match=r"repro_torch\.prefix"):
        tsched.ContinuousScheduler(tm, tp, tsched.SchedulerConfig(
            max_batch=2, max_seq=MAX_SEQ, chunk_size=4), prefix_cache=object())
    # a disabled SLO config is FIFO, as in the reference
    sched = tsched.ContinuousScheduler(tm, tp, tsched.SchedulerConfig(
        max_batch=2, max_seq=MAX_SEQ, slo=TorchSLOConfig(enable=False)))
    assert dataclasses.asdict(TorchSLOConfig()) == \
        dataclasses.asdict(JaxSLOConfig())
    sched.close()
