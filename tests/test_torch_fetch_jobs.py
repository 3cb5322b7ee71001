"""Each planned layer's KV pages fetched as one transfer job that copies
them straight into their batch-cache slots (``MemoryPoolManager.
prefetch_many``, ``PlanPrefetcher.issue``), on the CPU.

The port's scheduler, landing pages in place, runs beside the JAX
package's, which fetches page by page and scatters: the same greedy
tokens, the same scheduler, pool, transfer and prefetch counts (a job of
*n* pages counts *n* transfers). The session's ``transfer_clock`` counts
the jobs and their pages; a job given no destinations returns the pages a
single-key fetch returns; and a preemption with landings in flight waits
for them before the slot's next occupant writes it. Greedy decoding only.
"""

import dataclasses
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro import sched as jsched
from repro.configs import REGISTRY as JAX_REGISTRY
from repro.core.costmodel import TPU_V5E as JAX_TPU_V5E
from repro.models.model import build_model as jax_build_model
from repro.offload.kvcache import worst_case_page_bytes as jax_row_bytes
from repro.pool import TransferEngine as JaxTransferEngine
from repro.pool import default_pool as jax_default_pool
from repro.slo.policy import SLOConfig as JaxSLOConfig
from repro.slo.policy import SLOSpec as JaxSLOSpec
from repro_torch import sched as tsched
from repro_torch.api import HyperOffloadSession, OffloadConfig
from repro_torch.api.config import TelemetryConfig
from repro_torch.configs import REGISTRY as TORCH_REGISTRY
from repro_torch.convert import params_from_numpy
from repro_torch.core.costmodel import TPU_V5E as TORCH_TPU_V5E
from repro_torch.models.model import build_model as torch_build_model
from repro_torch.obs import OverlapAnalyzer, Tracer
from repro_torch.obs.check import validate_events
from repro_torch.pool import default_pool as torch_default_pool
from repro_torch.pool.topology import TierSpec, TierTopology
from repro_torch.pool.transfer import CopyGroup, TransferEngine
from repro_torch.serving.engine import _flatten
from repro_torch.slo.policy import SLOConfig as TorchSLOConfig
from repro_torch.slo.policy import SLOSpec as TorchSLOSpec

CPU = torch.device("cpu")
ARCH = "phi3-mini-3.8b"
MAX_SEQ = 32
LAYERS = 3


def _deeper(cfg):
    """The reduced config at ``LAYERS`` layers: one job per layer a step."""
    return dataclasses.replace(cfg, segments=tuple(
        dataclasses.replace(s, repeats=LAYERS) for s in cfg.segments))


@pytest.fixture(scope="module")
def pair():
    jm = jax_build_model(_deeper(JAX_REGISTRY[ARCH].reduced()))
    tm = torch_build_model(_deeper(TORCH_REGISTRY[ARCH].reduced()))
    jp = jm.init(jax.random.key(0))
    return jm, jp, tm, params_from_numpy(jax.tree.map(np.asarray, jp), CPU)


def _requests(pkg, vocab, n=4, arrival_step=1.0):
    rng = np.random.default_rng(5)
    return [pkg.Request(tokens=rng.integers(0, vocab, size=4 + 2 * i,
                                            dtype=np.int32),
                        max_new_tokens=3 + 2 * i, arrival=arrival_step * i,
                        seed=i)
            for i in range(n)]


def _pools(case, jm, tm):
    if case == "device":
        return jax_default_pool(), torch_default_pool(device="cpu")
    row = jax_row_bytes(jm.cache_specs(1, MAX_SEQ, np.float32))
    # a device tier of 1.5 rows: a step's jobs read the device and host
    # tiers (or the codec's host tier) at once
    caps = dict(device_capacity=int(1.5 * row), host_capacity=8 * row)
    if case == "spill-int8":
        caps.update(codec="int8", codec_below="host")
    return (jax_default_pool(transfer=JaxTransferEngine(depth=64), **caps),
            torch_default_pool(transfer_depth=64, device="cpu", **caps))


def _pool_counts(snap):
    """A pool snapshot without what depends on timing or the framework."""
    out = {}
    for k, v in snap.items():
        if k == "transfer":
            v = {kk: v[kk] for kk in ("issued", "completed")}
            v["pairs"] = {p: (d["transfers"], d["bytes"])
                          for p, d in snap["transfer"]["pairs"].items()}
        elif isinstance(v, dict):
            v = {kk: vv for kk, vv in v.items() if kk != "backend"}
        out[k] = v
    return out


def _lockstep(pair, jpool, tpool, jreqs, treqs, check_slots=False, **kw):
    jm, jp, tm, tp = pair
    slo = kw.pop("slo", False)
    jkw, tkw = dict(kw), dict(kw)
    if slo:
        jkw["slo"], tkw["slo"] = (JaxSLOConfig(enable=True),
                                  TorchSLOConfig(enable=True))
    js = jsched.ContinuousScheduler(
        jm, jp, jsched.SchedulerConfig(hw=JAX_TPU_V5E, **jkw), pool=jpool)
    ts = tsched.ContinuousScheduler(
        tm, tp, tsched.SchedulerConfig(hw=TORCH_TPU_V5E, **tkw), pool=tpool)
    ids = {t.req_id: j.req_id for j, t in zip(jreqs, treqs)}
    for j, t in zip(jreqs, treqs):
        js.submit(j)
        ts.submit(t)
    while len(js.queue) or js.active or js.preempted:
        if (not js.active and not js.preempted
                and js.queue.head_ready(js.now) is None):
            js.now = max(js.now, js.queue.next_arrival())
            ts.now = max(ts.now, ts.queue.next_arrival())
        je, te = js.step(), ts.step()
        assert [(ids[r], t) for r, t in te] == je
        assert dataclasses.asdict(ts.stats) == dataclasses.asdict(js.stats)
        assert ts.pool_stats()["transfer"]["issued"] == \
            js.pool_stats()["transfer"]["issued"]
        if check_slots:
            _slots_hold_their_rows(js, ts, ids)
    tout = {ids[r]: st.tokens_array() for r, st in ts.finished.items()}
    jout = {r: st.tokens_array() for r, st in js.finished.items()}
    assert tout.keys() == jout.keys()
    for r in jout:
        np.testing.assert_array_equal(tout[r], jout[r])
    assert ts.prefetch_stats() == js.prefetch_stats()
    assert _pool_counts(ts.pool_stats()) == _pool_counts(js.pool_stats())
    return js, ts


def _slots_hold_their_rows(js, ts, ids):
    """Every decoding row's written positions in the port's batch cache
    equal the reference's, after the step's waits (nothing landed on a
    slot's new occupant)."""
    jleaves = [np.asarray(x) for x in jax.tree.leaves(js.cache)]
    tleaves = _flatten(ts.cache)[0]
    jslot = {s.req_id: s.slot for s in js.slots if s is not None}
    for s in ts.slots:
        if s is None or s.status != tsched.DECODE:
            continue
        j = jslot[ids[s.req_id]]
        for jl, tl in zip(jleaves, tleaves):
            np.testing.assert_allclose(tl[:, s.slot, :s.pos].numpy(),
                                       jl[:, j, :s.pos], rtol=1e-4,
                                       atol=1e-5)


CASES = {
    # every page on the device tier: device->device copies into the slots
    "device": dict(kv_offload=True),
    # rows spill to the host tier: jobs read two tiers, host pages first
    "spill": dict(kv_offload=True),
    # an int8 host tier: its pages are decoded, then copied into the slots
    "spill-int8": dict(kv_offload=True),
    # chunked prefill: parked partial rows come back as pages (no dests)
    "chunk4": dict(kv_offload=True, chunk_size=4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_landing_in_place_matches_the_reference(pair, case):
    jm, _, tm, _ = pair
    jpool, tpool = _pools("device" if case == "chunk4" else case, jm, tm)
    vocab = tm.cfg.vocab_size
    _, ts = _lockstep(pair, jpool, tpool, _requests(jsched, vocab),
                      _requests(tsched, vocab), max_batch=2,
                      max_seq=MAX_SEQ, **CASES[case])
    pf = ts.prefetch_stats()
    # one job per planned layer of every issue, each page counted once
    assert pf["layers_planned"] == LAYERS
    assert tpool.fetch_jobs == LAYERS * pf["steps"] > 0
    assert tpool.fetch_job_pages == pf["fetches_issued"]
    pairs = ts.pool_stats()["transfer"]["pairs"]
    if case.startswith("spill"):
        assert pairs["host->device"]["transfers"] > 0
        assert ts.stats.cold_spills > 0
    ts.close()
    tpool.close()
    jpool.close()


@pytest.mark.parametrize("rows", [1, 3])
def test_transfer_clock_counts_a_job_per_layer_and_step(pair, rows):
    """``rows`` requests join together and decode ``new`` tokens: every
    step that parks issues one job per planned layer, each carrying every
    live row's leaves of that layer."""
    _, _, tm, tp = pair
    new = 5
    # a leaf holds every layer of the segment (one pattern position)
    leaves = len(_flatten(tm.init_cache(1, MAX_SEQ, torch.float32,
                                        device=CPU))[0])
    cfg = OffloadConfig(mode="kv_offload", max_batch=rows, max_seq=MAX_SEQ,
                        prefill_budget=rows,
                        telemetry=TelemetryConfig(enable=True))
    with HyperOffloadSession(cfg, device="cpu") as s:
        sched = s.scheduler(tm, tp)
        sched.run([tsched.Request(tokens=np.arange(6, dtype=np.int32) + i,
                                  max_new_tokens=new, seed=i)
                   for i in range(rows)])
        clock = s.stats()["transfer_clock"]
    # tokens 2..new come from decode steps; all but the last one park
    assert clock["fetch_jobs"] == LAYERS * (new - 2)
    assert clock["fetch_job_pages"] == \
        clock["fetch_jobs"] * rows * leaves


TOPOLOGIES = {
    "device": dict(),
    "device+host": dict(device_capacity=3 * 64 * 4),
    "host-int8": dict(device_capacity=3 * 64 * 4, codec="int8"),
    "remote": "remote",
}


def _pool_for(name):
    layout = TOPOLOGIES[name]
    if layout == "remote":
        # a pageable CPU tier behind the device: read with get()
        topo = TierTopology((TierSpec("device", "device", capacity=3 * 256),
                             TierSpec("remote", "numpy")))
        return torch_default_pool(device="cpu", topology=topo,
                                  transfer_depth=4)
    return torch_default_pool(device="cpu", transfer_depth=4, **layout)


@pytest.mark.parametrize("topology", sorted(TOPOLOGIES))
def test_a_job_without_dests_returns_what_single_fetches_return(topology):
    """Eight pages, most spilled below the device tier: one job of all
    of them (no destinations, as the chunked restore and a resume issue
    it; twice the engine's depth) returns, key by key, the tensors
    single-key fetches return, as new tensors, and counts what they count;
    a job with destinations writes them and returns nothing."""
    pages = {f"p{i}": torch.arange(64, dtype=torch.float32) * (i + 1)
             for i in range(8)}
    pool = _pool_for(topology)
    try:
        for k, v in pages.items():
            pool.put(k, v, pool.top_tier)
        tiers = {pool.tier_of(k) for k in pages}
        assert len(tiers) == (1 if topology == "device" else 2)
        keys = sorted(pages, reverse=True)
        before = pool.snapshot()
        singles = {k: pool.prefetch(k).wait() for k in keys}
        mid = pool.snapshot()
        job = pool.prefetch_many(keys)
        got = dict(zip(keys, job.wait()))
        after = pool.snapshot()
        for k in keys:
            assert torch.equal(got[k], singles[k])
            got[k].zero_()       # a new tensor: the pool's copy is intact
        assert all(torch.equal(pool.get(k), singles[k]) for k in keys)
        for field in ("gets", "bytes_fetched"):
            assert after[field] - mid[field] == mid[field] - before[field]
        for field in ("issued", "completed"):
            assert after["transfer"][field] - mid["transfer"][field] == \
                mid["transfer"][field] - before["transfer"][field] == 8
        assert pool.fetch_jobs == 1 and pool.fetch_job_pages == 8
        dests = [torch.full((64,), -1.0) for _ in keys]
        assert pool.prefetch_many(keys, dests).wait() is None
        assert all(torch.equal(d, singles[k]) for d, k in zip(dests, keys))
        with pytest.raises(ValueError, match="dests"):
            pool.prefetch_many(keys, dests[:1])
    finally:
        pool.close()


def test_a_mixed_tier_job_traces_a_span_per_tier():
    """Telemetry on: a job reading the device and host tiers is one
    ``transfer`` span per tier under one ``seq`` (host first), one wait;
    the overlap analyzer counts its pages as transfers, splits them by
    tier, and its hidden and exposed time equal the engine's."""
    tracer = Tracer()
    pool = torch_default_pool(device="cpu", device_capacity=3 * 256,
                              tracer=tracer)
    try:
        for i in range(8):
            pool.put(f"p{i}", torch.full((64,), float(i)), "device")
        keys = [f"p{i}" for i in range(8)]
        tracer.clear()
        before = pool.transfer.clock()
        pool.prefetch_many(keys, [torch.empty(64) for _ in keys]).wait()
        after = pool.transfer.clock()
    finally:
        pool.close()
    spans = [e for e in tracer.events() if e.name == "transfer"]
    assert [(e.args["src"], e.args["pages"]) for e in spans] == \
        [("host", 5), ("device", 3)]
    assert len({e.args["seq"] for e in spans}) == 1
    assert len([e for e in tracer.events() if e.name == "transfer.wait"]) \
        == 1
    rep = OverlapAnalyzer.from_tracer(tracer).report()
    assert rep["transfers"] == 8
    assert {p: b["transfers"] for p, b in rep["by_tier"].items()} == \
        {"host->device": 5, "device->device": 3}
    for key in ("hidden_s", "exposed_s"):
        assert rep[key] == pytest.approx(after[key] - before[key],
                                         rel=1e-6, abs=1e-9), key
    assert validate_events(tracer.to_chrome()) == []


def test_jobs_hold_their_pages_against_depth_under_contention():
    """Sixteen threads (more than the cores) submit jobs of 1-5 pages to an
    engine of depth 6 and two workers, with a short switch interval: every
    page is issued and completed once, no more than ``depth`` places are
    ever held (a 5-page job waits for room), and none is left held."""
    eng = TransferEngine(depth=6, workers=2)
    sizes = [1 + (i % 5) for i in range(16 * 12)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def submit(chunk):
            for n in chunk:
                h = eng.submit_job(
                    [CopyGroup(lambda t: None, n, "host", "device", n)],
                    lambda: n)
                assert h.wait() == n

        threads = [threading.Thread(target=submit, args=(sizes[i::16],))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        eng.drain()
    finally:
        sys.setswitchinterval(interval)
        eng.close()
    st = eng.stats
    assert st.issued == st.completed == sum(sizes)
    assert st.pairs["host->device"]["transfers"] == sum(sizes)
    assert st.max_in_flight <= 6 and eng._held == 0


def test_prefetcher_wait_all_without_dests_returns_pages_by_key(pair):
    """The restore paths' ``issue(...).wait_all()``: a dict of every key's
    page, equal to a single-key fetch of it."""
    _, _, tm, _ = pair
    pool = torch_default_pool(device="cpu")
    try:
        pf = tsched.PlanPrefetcher(tm.cfg, 1, MAX_SEQ, pool=pool)
        keys_by_layer = {}
        for layer in pf.planned_layers:
            for j in range(2):
                key = f"L{layer}.{j}"
                pool.put(key, torch.randn(MAX_SEQ, 4), "device")
                keys_by_layer.setdefault(layer, []).append(key)
        fetched = pf.issue(keys_by_layer).wait_all()
        assert sorted(fetched) == sorted(k for ks in keys_by_layer.values()
                                         for k in ks)
        for k, v in fetched.items():
            assert torch.equal(v, pool.prefetch(k).wait())
        assert pool.fetch_jobs == len(pf.planned_layers)
    finally:
        pool.close()


#: an overload trace on 2 slots with SLO admission: deadline-pressed
#: interactive arrivals preempt decoding batch rows, and whole-prompt
#: prefill scatters each newcomer into the freed slot at once
SLO_TRACE = dict(rate=2.0, prompt_lens=(4, 16), new_tokens=(3, 12),
                 prompt_quantum=4, interactive_fraction=0.4, seed=15)


def test_a_preemption_waits_for_landings_before_the_slot_is_reused(
        pair, monkeypatch):
    """Landings slowed to 30 ms a job: a preempted row's in-flight pages
    would land on the new occupant's freshly prefilled row if the slot
    were handed over before they landed. Tokens stay the reference's, and
    after every step each decoding row holds what the reference holds."""
    jm, _, tm, _ = pair
    jpool, tpool = jax_default_pool(), torch_default_pool(device="cpu")
    copy_many = tpool.transfer.copy_many

    def slow(pairs, timings):
        time.sleep(0.03)
        copy_many(pairs, timings)

    monkeypatch.setattr(tpool.transfer, "copy_many", slow)
    vocab = tm.cfg.vocab_size
    jreqs = jsched.poisson_trace(
        10, vocab_size=vocab,
        interactive_slo=JaxSLOSpec("interactive", ttft_deadline=6.0),
        **SLO_TRACE)
    treqs = tsched.poisson_trace(
        10, vocab_size=vocab,
        interactive_slo=TorchSLOSpec("interactive", ttft_deadline=6.0),
        **SLO_TRACE)
    preempted_decoding = []
    preempt = tsched.ContinuousScheduler._preempt

    def spy(self, victim):
        preempted_decoding.append(victim.status == tsched.DECODE
                                  and self._inflight is not None)
        preempt(self, victim)

    monkeypatch.setattr(tsched.ContinuousScheduler, "_preempt", spy)
    _, ts = _lockstep(pair, jpool, tpool, jreqs, treqs, check_slots=True,
                      max_batch=2, max_seq=MAX_SEQ, kv_offload=True,
                      slo=True)
    assert any(preempted_decoding), preempted_decoding
    assert ts.stats.resumes == ts.stats.preemptions
    ts.close()
    tpool.close()
    jpool.close()
