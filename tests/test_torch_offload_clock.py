"""Where the offload path's time is spent, on the CPU: the transfer engine's
copy-time counters (``clock()``: hidden and exposed fetch time, copy
seconds per tier pair), the pool's ``pool/spill`` spans, the scheduler's
host-clock queue wait (``session.stats()["sched_clock"]``) and the trace's
named copy-stream lane. On the CPU a copy's time is the host interval of
its thunk; the card's copy-stream timing is held against the profiler in
``tests/test_torch_cuda.py``."""

import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.api import HyperOffloadSession, OffloadConfig
from repro_torch.api.config import TelemetryConfig
from repro_torch.configs import REGISTRY
from repro_torch.models.model import build_model
from repro_torch.obs import OverlapAnalyzer, Tracer
from repro_torch.pool import default_pool
from repro_torch.pool.transfer import TransferEngine, copy_lane
from repro_torch.sched import QUEUED, Request

CPU = torch.device("cpu")
CFG = REGISTRY["phi3-mini-3.8b"].reduced()
PAGE = 64 * 4        # bytes of one float32 page of 64


@pytest.fixture(scope="module")
def model_and_params():
    m = build_model(CFG)
    return m, m.init(torch.Generator().manual_seed(0), device="cpu")


def _page(v: float) -> torch.Tensor:
    return torch.full((64,), v)


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------


def test_to_chrome_names_the_copy_stream_lane():
    tr = Tracer()
    lane = copy_lane(torch.device("cuda", 0))
    assert lane == "copy stream cuda:0"
    tr.complete("transfer", "transfer", tr.now(), 1e-3, {"seq": 1}, lane=lane)
    tr.complete("transfer", "transfer", tr.now(), 1e-3, {"seq": 2}, lane=lane)
    with tr.span("sched", "step", step=0):
        pass
    rows = tr.to_chrome()["traceEvents"]
    names = {r["tid"]: r["args"]["name"] for r in rows
             if r["ph"] == "M" and r["name"] == "thread_name"}
    spans = {r["name"]: r["tid"] for r in rows if r["ph"] == "X"}
    assert names[spans["transfer"]] == lane
    assert names[spans["step"]] == f"thread-{spans['step']}"
    assert [r["tid"] for r in rows if r.get("name") == "transfer"] == \
        [spans["transfer"]] * 2
    assert len(names) == 2


# ---------------------------------------------------------------------------
# the transfer engine
# ---------------------------------------------------------------------------


def test_engine_hidden_and_exposed_equal_the_analyzer():
    """Four 20 ms transfers, each on a worker of its own: two waited on
    while they run (part exposed), two after they landed (all hidden).
    The engine's counters, taken at the first waits, equal the analyzer's
    decomposition of the same run's trace within 1 %."""
    tr = Tracer()
    eng = TransferEngine(depth=8, workers=4, tracer=tr)
    started = [threading.Event() for _ in range(4)]

    def copy(i):
        started[i].set()
        time.sleep(0.02)
        return i

    try:
        hs = [eng.submit(lambda i=i: copy(i), key=f"k{i}", src="host",
                         dst="device", nbytes=PAGE) for i in range(4)]
        assert all(e.wait(timeout=10) for e in started)
        # a wait that blocks longer than the copy ran would charge its
        # queue time too, which the engine leaves out: wait inside it
        time.sleep(0.008)
        assert [h.wait() for h in hs[:2]] == [0, 1]
        time.sleep(0.05)           # the last two have landed
        assert [h.wait() for h in hs[2:]] == [2, 3]
    finally:
        eng.close()
    st = eng.stats
    rep = OverlapAnalyzer.from_tracer(tr).report()
    assert st.waits_blocked >= 1 and st.waits_overlapped >= 2
    assert st.exposed_s > 0 and st.hidden_s > 0
    assert st.hidden_s + st.exposed_s == pytest.approx(
        rep["hidden_s"] + rep["exposed_s"], rel=0.01)
    assert st.exposed_s == pytest.approx(rep["exposed_s"], rel=0.01)
    clock = eng.clock()
    pair = clock["pairs"]["host->device"]
    assert pair["transfers"] == 4 and pair["bytes"] == 4 * PAGE
    assert pair["device_s"] == pytest.approx(clock["hidden_s"]
                                             + clock["exposed_s"])
    assert pair["device_s"] >= 4 * 0.02


def test_engine_times_nothing_with_telemetry_off():
    eng = TransferEngine(depth=4, workers=2)
    try:
        hs = [eng.submit(lambda i=i: i, src="host", dst="device",
                         nbytes=PAGE) for i in range(3)]
        assert [h.wait() for h in hs] == [0, 1, 2]
    finally:
        eng.close()
    assert eng.clock() == {"hidden_s": 0.0, "exposed_s": 0.0, "pairs": {}}
    assert eng.stats.pairs["host->device"]["transfers"] == 3


# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------


def test_spill_spans_nest_inside_the_put_that_caused_them():
    """A put into a full device tier spills its victim to a full host
    tier, which spills its own to the remote tier: two ``pool/spill``
    spans inside the put's, one after the other, each with its tiers and
    bytes and nothing else."""
    tr = Tracer()
    pool = default_pool(device=CPU, device_capacity=2 * PAGE,
                        host_capacity=PAGE, tracer=tr)
    try:
        pool.put("h", _page(0.0), "host")
        pool.put("a", _page(1.0), "device")
        pool.put("b", _page(2.0), "device")
        tr.clear()
        pool.put("c", _page(3.0), "device")      # a -> host, h -> remote
        assert pool.tier_of("a") == "host" and pool.tier_of("h") == "remote"
    finally:
        pool.close()
    put = [e for e in tr.events() if e.cat == "pool" and e.name == "put"]
    spills = [e for e in tr.events() if e.cat == "pool" and e.name == "spill"]
    assert len(put) == 1 and len(spills) == 2
    assert all(e.ph == "X" for e in spills)
    assert [e.args for e in spills] == [
        {"src": "host", "dst": "remote", "nbytes": PAGE},
        {"src": "device", "dst": "host", "nbytes": PAGE}]
    assert put[0].args == {"tier": "device", "nbytes": PAGE}
    for e in spills:
        assert put[0].ts <= e.ts and e.end <= put[0].end
        assert e.tid == put[0].tid
    assert spills[0].end <= spills[1].ts      # a cascade does not nest
    # the clock files what the pair table files: puts below the device
    # tier and spills, each with its copy's time
    clock, table = pool.transfer.clock()["pairs"], \
        pool.transfer.stats.pairs
    assert {p: (v["transfers"], v["bytes"]) for p, v in clock.items()} == \
        {p: (v["transfers"], v["bytes"]) for p, v in table.items()} == \
        {"device->host": (2, 2 * PAGE), "host->remote": (1, PAGE)}
    assert all(v["device_s"] > 0 for v in clock.values())


# ---------------------------------------------------------------------------
# the session and the scheduler
# ---------------------------------------------------------------------------


def test_session_reports_the_clocks_with_telemetry_on(model_and_params):
    """kv_offload over a one-row device tier: rows spill to the host and
    come back each step. Every spill and fetch is in the engine's clock
    table with the bytes of the pool's own pair table, and the session
    reports both clocks."""
    model, params = model_and_params
    row = 2 * CFG.n_layers * 32 * CFG.n_kv_heads * CFG.head_dim * 4
    cfg = OffloadConfig(mode="kv_offload", max_batch=2, max_seq=32,
                        device_capacity=row, host_capacity=16 * row,
                        telemetry=TelemetryConfig(enable=True))
    with HyperOffloadSession(cfg, device="cpu") as s:
        sched = s.scheduler(model, params)
        sched.run([Request(tokens=np.arange(4 + i, dtype=np.int32),
                           max_new_tokens=4, seed=i) for i in range(2)])
        st = s.stats()
    pairs, timed = st["pool"]["transfer"]["pairs"], \
        st["transfer_clock"]["pairs"]
    for pair in ("device->host", "host->device"):
        assert timed[pair]["bytes"] == pairs[pair]["bytes"] > 0
        assert timed[pair]["transfers"] == pairs[pair]["transfers"]
        assert timed[pair]["device_s"] > 0
    assert st["transfer_clock"]["hidden_s"] + \
        st["transfer_clock"]["exposed_s"] > 0
    assert st["sched_clock"]["admissions"] == 2
    assert st["sched_clock"]["queue_wait_s"] > 0
    spills = [e for e in s.tracer.events() if e.name == "spill"]
    assert spills and all(e.ph == "X" for e in spills)


def test_queue_wait_covers_the_time_a_full_batch_held_a_request(
        model_and_params):
    """One slot: the second request waits in the queue while the first
    decodes. Its host-clock wait is at least the time from its submit to
    the start of the step that admitted it."""
    model, params = model_and_params
    cfg = OffloadConfig(max_batch=1, max_seq=32,
                        telemetry=TelemetryConfig(enable=True))
    with HyperOffloadSession(cfg, device="cpu") as s:
        sched = s.scheduler(model, params)
        sched.submit(Request(tokens=np.arange(6, dtype=np.int32),
                             max_new_tokens=6, seed=0))
        sched.step()
        before = s.stats()["sched_clock"]
        assert before["admissions"] == 1
        second = sched.submit(Request(tokens=np.arange(5, dtype=np.int32),
                                      max_new_tokens=2, seed=1))
        t_submitted = time.perf_counter()
        held = None
        while held is None:
            t_step = time.perf_counter()
            sched.step()
            if second.status != QUEUED:
                held = t_step - t_submitted
        after = s.stats()["sched_clock"]
    assert sched.stats.steps >= 6          # it waited for whole steps
    assert after["admissions"] == 2
    assert after["queue_wait_s"] - before["queue_wait_s"] >= held > 0


def test_the_clocks_stay_out_of_stats_with_telemetry_off(model_and_params):
    model, params = model_and_params
    with HyperOffloadSession(OffloadConfig(max_batch=1, max_seq=32),
                             device="cpu") as s:
        sched = s.scheduler(model, params)
        sched.run([Request(tokens=np.arange(4, dtype=np.int32),
                           max_new_tokens=2, seed=0)])
        st = s.stats()
    assert "sched_clock" not in st and "transfer_clock" not in st
    # the scheduler keeps its host-clock reading all the same
    assert sched.clock.admissions == 1
