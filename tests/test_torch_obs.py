"""The port's telemetry analysis (``repro_torch.obs.overlap``,
``repro_torch.obs.check``) and closed-loop calibration
(``repro_torch.core.calibration``) against the JAX package's, on the CPU.

These are pure functions: over the same synthetic events, the same trace
objects and the same per tier-pair tables they must give equal results
(floats equal: both sides run the same Python arithmetic). Then a real
``TransferEngine`` and a telemetry-on session: the trace's exposed time is
the engine's ``blocked_s`` exactly, per-handle ordering holds, and an
exported trace passes the checker. Wall-clock values are compared only
within one package."""

import json
import time

import numpy as np
import pytest
import torch

from repro.core import calibration as jax_cal
from repro.core.costmodel import TPU_V5E as JAX_TPU_V5E
from repro.obs import OverlapAnalyzer as JaxOverlapAnalyzer
from repro.obs import TraceEvent as JaxTraceEvent
from repro.obs import check as jax_check
from repro_torch.api import HyperOffloadSession, OffloadConfig
from repro_torch.api.config import TelemetryConfig
from repro_torch.api.session import _weighted_plan_lead
from repro_torch.configs import REGISTRY
from repro_torch.core import calibration as cal
from repro_torch.core.costmodel import H100, TPU_V5E
from repro_torch.models.model import build_model
from repro_torch.obs import (
    NULL_TRACER, OverlapAnalyzer, TraceEvent, Tracer,
)
from repro_torch.obs.check import main as check_main
from repro_torch.obs.check import validate_events, validate_file
from repro_torch.pool.transfer import TransferEngine
from repro_torch.sched import Request

CFG = REGISTRY["phi3-mini-3.8b"].reduced()


# ---------------------------------------------------------------------------
# overlap analyzer on synthetic traces
# ---------------------------------------------------------------------------


def _transfer_events(cls):
    """Two transfers: seq 1 waited-blocked (0.2 s exposed of 1.0 in flight),
    seq 2 never waited (fully hidden, 0.5 s), one sched step span holding
    the wait, a hit wait on a third transfer in a second step, and a
    transfer span whose wait fell off the ring."""
    return [
        cls("sched", "step", "X", 0.0, 2.0, args={"step": 0}),
        cls("transfer", "transfer", "X", 0.0, 1.0,
            args={"seq": 1, "src": "host", "dst": "device"}),
        cls("transfer", "transfer.wait", "X", 0.8, 0.2,
            args={"seq": 1, "hit": False}),
        cls("transfer", "transfer", "X", 0.5, 0.5,
            args={"seq": 2, "src": "remote", "dst": "device"}),
        cls("sched", "step", "X", 2.5, 1.0, args={"step": 1}),
        cls("transfer", "transfer", "X", 2.0, 0.25,
            args={"seq": 3, "src": "host", "dst": "device"}),
        cls("transfer", "transfer.wait", "X", 3.0, 0.001,
            args={"seq": 3, "hit": True}),
    ]


def test_overlap_decomposition_equals_the_reference():
    rep = OverlapAnalyzer(_transfer_events(TraceEvent)).report()
    assert rep == JaxOverlapAnalyzer(
        _transfer_events(JaxTraceEvent)).report()
    assert rep["transfers"] == 3
    assert rep["waits_blocked"] == 1 and rep["waits_overlapped"] == 1
    assert rep["exposed_s"] == pytest.approx(0.2)
    assert rep["hidden_s"] == pytest.approx(0.8 + 0.5 + 0.25)
    assert rep["inflight_s"] == pytest.approx(1.75)
    assert rep["by_tier"]["host->device"]["exposed_s"] == pytest.approx(0.2)
    assert rep["by_tier"]["remote->device"]["hidden_fraction"] == 1.0
    assert [s["step"] for s in rep["by_step"]] == [0, 1]


def test_overlap_validate_against_stats():
    an, jan = (OverlapAnalyzer(_transfer_events(TraceEvent)),
               JaxOverlapAnalyzer(_transfer_events(JaxTraceEvent)))
    good = {"waits_overlapped": 1, "waits_blocked": 1, "blocked_s": 0.2}
    assert an.validate(good) == jan.validate(good) == []
    bad = {"waits_overlapped": 3, "waits_blocked": 1, "blocked_s": 0.9}
    errs = an.validate(bad)
    assert errs == jan.validate(bad)
    assert any("waits_overlapped" in e for e in errs)
    assert any("blocked_s" in e for e in errs)


def test_overlap_orphan_waits():
    def evs(cls):
        return [cls("transfer", "transfer.wait", "X", 0.8, 0.2,
                    args={"seq": 99, "hit": False})]
    an, jan = OverlapAnalyzer(evs(TraceEvent)), \
        JaxOverlapAnalyzer(evs(JaxTraceEvent))
    assert an.orphan_waits == jan.orphan_waits == 1
    for stats in ({"waits_overlapped": 1, "waits_blocked": 0,
                   "blocked_s": 0.0},
                  {"waits_overlapped": 5, "waits_blocked": 2,
                   "blocked_s": 0.0}):
        assert an.validate(stats) == jan.validate(stats)
    assert an.validate({"waits_overlapped": 1, "waits_blocked": 0,
                        "blocked_s": 0.0}) == []


def test_overlap_hidden_fraction_none_without_time():
    assert OverlapAnalyzer([]).report()["hidden_fraction"] is None
    assert OverlapAnalyzer([]).report() == JaxOverlapAnalyzer([]).report()


# ---------------------------------------------------------------------------
# schema checker
# ---------------------------------------------------------------------------


def _span(name, ts, dur, args):
    return {"name": name, "cat": "transfer", "ph": "X", "ts": ts,
            "dur": dur, "pid": 1, "tid": 0, "args": args}


CHECKER_CASES = {
    "not-an-object": [1, 2],
    "no-events": {"nope": []},
    "events-not-a-list": {"traceEvents": {}},
    "bad-ph": {"traceEvents": [
        {"name": "x", "ph": "Q", "ts": 0, "pid": 1, "tid": 0}]},
    "negative-dur": {"traceEvents": [
        {"name": "x", "ph": "X", "ts": 5.0, "dur": -2.0, "pid": 1,
         "tid": 0}]},
    "no-spans": {"traceEvents": [
        {"name": "x", "ph": "i", "ts": 0, "pid": 1, "tid": 0, "s": "t"}]},
    "missing-seq": {"traceEvents": [_span("transfer", 0.0, 1.0, {})]},
    "step-without-index": {"traceEvents": [
        {"name": "step", "cat": "sched", "ph": "X", "ts": 0.0, "dur": 1.0,
         "pid": 1, "tid": 0, "args": {}}]},
    "wait-before-complete": {"traceEvents": [
        _span("transfer", 1000.0, 500.0, {"seq": 1}),
        _span("transfer.wait", 100.0, 50.0, {"seq": 1, "hit": False})]},
    "hit-wait-too-early": {"traceEvents": [
        _span("transfer", 1000.0, 500.0, {"seq": 1}),
        _span("transfer.wait", 1200.0, 400.0, {"seq": 1, "hit": True})]},
    # a blocked wait may start before the transfer span (queue time)
    "blocked-wait-early-start": {"traceEvents": [
        _span("transfer", 1000.0, 500.0, {"seq": 1}),
        _span("transfer.wait", 100.0, 1400.0, {"seq": 1, "hit": False})]},
}


@pytest.mark.parametrize("case", sorted(CHECKER_CASES))
def test_checker_agrees_with_the_reference(case):
    obj = CHECKER_CASES[case]
    errs = validate_events(obj)
    assert errs == jax_check.validate_events(obj)
    assert (errs == []) == (case == "blocked-wait-early-start")
    if case == "wait-before-complete":
        assert any("before its transfer completed" in e for e in errs)
    if case == "hit-wait-too-early":
        assert any("before the transfer completed" in e for e in errs)


def test_checker_file_and_cli(tmp_path, capsys):
    junk = tmp_path / "junk.json"
    junk.write_text("{not json")
    assert any("not readable" in e for e in validate_file(str(junk)))
    tr = Tracer()
    with tr.span("sched", "step", step=0):
        tr.instant("request", "QUEUED", {"req": 1})
    path = str(tmp_path / "trace.json")
    tr.export(path)
    assert validate_file(path) == jax_check.validate_file(path) == []
    assert check_main([path]) == 0
    assert "valid Chrome trace" in capsys.readouterr().out
    assert check_main([str(junk)]) == 1


# ---------------------------------------------------------------------------
# calibration (pure functions)
# ---------------------------------------------------------------------------


PAIRS = {
    "host->device": {"transfers": 40, "bytes": 40 * 65536, "busy_s": 0.004},
    "remote->device": {"transfers": 6, "bytes": 6 * 65536, "busy_s": 0.03},
    "device->host": {"transfers": 12, "bytes": 12 * 65536, "busy_s": 0.002},
    "host->remote": {"transfers": 3, "bytes": 3 * 65536, "busy_s": 0.01},
    "device->remote": {"transfers": 1, "bytes": 512, "busy_s": 0.5},
}


@pytest.mark.parametrize("min_transfers,min_bytes", [(2, 1024), (1, 0),
                                                     (10, 1 << 20)])
def test_calibration_equals_the_reference(min_transfers, min_bytes):
    ms = cal.measurements_from_pairs(PAIRS)
    jms = jax_cal.measurements_from_pairs(PAIRS)
    assert {k: (m.transfers, m.nbytes, m.busy_s, m.bandwidth)
            for k, m in ms.items()} == \
        {k: (m.transfers, m.nbytes, m.busy_s, m.bandwidth)
         for k, m in jms.items()}
    spec = cal.calibrate(TPU_V5E, ms, device_tier="device",
                         min_transfers=min_transfers, min_bytes=min_bytes)
    jspec = jax_cal.calibrate(JAX_TPU_V5E, jms, device_tier="device",
                              min_transfers=min_transfers,
                              min_bytes=min_bytes)
    assert spec.name == jspec.name == "tpu_v5e+measured"
    assert (spec.pool_bw_d2r, spec.pool_bw_r2d) == \
        (jspec.pool_bw_d2r, jspec.pool_bw_r2d)
    assert spec.pair_bw == jspec.pair_bw
    for src, dst in (("host", "device"), ("remote", "device"),
                     ("nvme", "device")):
        assert spec.bandwidth_between(src, dst) == \
            jspec.bandwidth_between(src, dst)
        assert spec.transfer_time(1 << 20, "r2d") == \
            jspec.transfer_time(1 << 20, "r2d")
    # calibrating a calibrated spec never stacks name suffixes
    assert cal.calibrate(spec, ms).name == "tpu_v5e+measured"
    for pages, window in ((0, 0.01), (64, 0.0), (64, 1e-3), (196, 2e-4),
                          (4096, 1e-5)):
        kw = dict(pages_per_step=pages, window_s=window, device_tier="device",
                  cap=64, min_transfers=min_transfers, min_bytes=min_bytes)
        assert cal.required_inflight(ms, **kw) == \
            jax_cal.required_inflight(jms, **kw)
    # the port's own spec calibrates the same way
    assert cal.calibrate(H100, ms).name == "h100_sxm+measured"


def _registry(cls):
    reg = cls()
    c = reg.counter("reqs_total", help="requests")
    c.inc()
    c.inc(2)
    with pytest.raises(ValueError):
        c.inc(-1)
    assert reg.counter("reqs_total") is c      # idempotent getter
    reg.gauge("depth").set(7)
    h = reg.histogram("lat", (1, 2, 4))
    for v in (0.5, 1.5, 3.0, 100.0):
        h.observe(v)
    with pytest.raises(ValueError):
        reg.histogram("lat", (1, 2, 8))        # bucket mismatch
    for bad in ((4, 2, 1), ()):
        with pytest.raises(ValueError):
            cls().histogram("bad", bad)
    reg.register_collector("pool", lambda: {"puts": 3, "tier": {"used": 9},
                                            "name": "host", "ok": True})
    return reg, h


def test_registry_instruments_and_prometheus_equal_the_reference():
    from repro.obs import MetricsRegistry as JaxMetrics
    from repro_torch.obs import MetricsRegistry
    reg, h = _registry(MetricsRegistry)
    jreg, jh = _registry(JaxMetrics)
    snap = h.snapshot()
    assert snap == jh.snapshot()
    assert snap["count"] == 4 and snap["buckets"] == {1: 1, 2: 2, 4: 3}
    text = reg.render_prometheus()
    assert text == jreg.render_prometheus()
    assert 'lat_bucket{le="+Inf"} 4' in text and "pool_tier_used 9" in text
    assert "pool_name" not in text and "pool_ok" not in text
    assert reg.collect() == jreg.collect()


def test_weighted_plan_lead():
    assert _weighted_plan_lead([(99, 2.0), (1, 10.0)]) == \
        pytest.approx((99 * 2.0 + 10.0) / 100)
    assert _weighted_plan_lead([(0, 3.0), (0, 5.0)]) == pytest.approx(4.0)
    assert _weighted_plan_lead([(5, 1.5)]) == pytest.approx(1.5)


# ---------------------------------------------------------------------------
# a real transfer engine, and the session's telemetry
# ---------------------------------------------------------------------------


def test_transfer_engine_handle_ordering():
    tr = Tracer()
    eng = TransferEngine(depth=4, tracer=tr)
    try:
        h_slow = eng.submit(lambda: time.sleep(0.01) or "a", key="slow",
                            src="host", dst="device")
        h_fast = eng.submit(lambda: "b", key="fast")
        time.sleep(0.05)          # let 'fast' complete before its wait
        assert h_fast.wait() == "b" and h_slow.wait() == "a"
        h_fast.wait()             # idempotent: no second wait span
    finally:
        eng.close()
    evs = tr.events()
    transfers = {e.args["seq"]: e for e in evs if e.name == "transfer"}
    waits = {e.args["seq"]: e for e in evs if e.name == "transfer.wait"}
    assert len(transfers) == 2 and len(waits) == 2
    assert waits[h_fast.seq].args["hit"] is True
    eps = 1e-4
    for seq, w in waits.items():
        t = transfers[seq]
        assert t.end >= t.ts
        assert w.end + eps >= t.end
        assert w.ts + eps >= t.ts
    # the trace's exposed time IS blocked_s (the same measurement)
    assert OverlapAnalyzer(evs).validate(eng.stats.snapshot(),
                                         tol_s=1e-9) == []


def test_transfer_engine_ensure_workers_grows_after_a_drain():
    eng = TransferEngine(depth=8, workers=1)
    h = eng.submit(lambda: time.sleep(0.01) or 1)
    eng.ensure_workers(4)
    assert eng.workers == 4 and h.done and h.wait() == 1
    eng.ensure_workers(2)                  # never lowers
    assert eng.workers == 4
    hs = [eng.submit(lambda i=i: i) for i in range(6)]
    assert [x.wait() for x in hs] == list(range(6))
    eng.close()


@pytest.fixture(scope="module")
def model_and_params():
    m = build_model(CFG)
    return m, m.init(torch.Generator().manual_seed(0), device="cpu")


def _run_requests(session, model_and_params, n=3):
    model, params = model_and_params
    sched = session.scheduler(model, params)
    reqs = [Request(tokens=(np.arange(4 + 2 * i) % CFG.vocab_size).astype(
        np.int32), max_new_tokens=3, seed=i) for i in range(n)]
    out = sched.run(reqs)
    return {i: out[r.req_id].tolist() for i, r in enumerate(reqs)}


def test_session_telemetry_end_to_end(model_and_params, tmp_path):
    path = str(tmp_path / "trace.json")
    outs = {}
    for enable in (False, True):
        cfg = OffloadConfig(mode="kv_offload", max_batch=2, max_seq=32,
                            chunk_size=6, telemetry=TelemetryConfig(
                                enable=enable,
                                trace_path=path if enable else None))
        with HyperOffloadSession(cfg, device="cpu") as s:
            outs[enable] = _run_requests(s, model_and_params)
            st = s.stats()
            if not enable:
                assert "telemetry" not in st
                assert s.tracer is NULL_TRACER and s.tracer.events() == []
                assert set(st) == {"mode", "pool", "serve", "sched",
                                   "paged", "prefix", "plans_cached"}
                with pytest.raises(RuntimeError):
                    s.export_trace(str(tmp_path / "never.json"))
                assert s.overlap() is None
                continue
            assert OverlapAnalyzer.from_tracer(s.tracer).validate(
                s.pool.snapshot()["transfer"],
                clock=s.transfer.clock()) == []
            rep = s.overlap()
            assert rep["transfers"] > 0 and rep["hidden_fraction"] is not None
            # kv_offload parks pages on the device tier (no spill here)
            assert set(rep["by_tier"]) == {"device->device"}
            names = [e.name for e in s.tracer.events() if e.cat == "request"]
            for name in ("QUEUED", "PREFILL", "DECODE", "DONE"):
                assert names.count(name) == 3
            cats = {(e.cat, e.name) for e in s.tracer.events()}
            assert ("sched", "step") in cats and ("pool", "put") in cats
            hists = st["telemetry"]["histograms"]["histograms"]
            assert hists["req_ttft_steps"]["count"] == 3
            assert "req_ttft_steps_bucket" in s.stats_text()
            assert s._overlap_window_s() > 0.0
    # telemetry is observation only: tokens are identical
    assert outs[False] == outs[True]
    # close() exported to trace_path; the file passes both checkers
    assert validate_file(path) == jax_check.validate_file(path) == []
    with open(path) as f:
        assert len(json.load(f)["traceEvents"]) > 0
