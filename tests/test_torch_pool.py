"""The PyTorch port's memory pool against the JAX package's: the same
put/get/prefetch/spill/drop sequence through both pools must give the same
counts, bytes, evictions and tier residency. Only the measured times
(``busy_s``, ``blocked_s``) may differ."""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.pool import PoolCapacityError as JaxPoolCapacityError
from repro.pool import TierSpec as JaxTierSpec
from repro.pool import TierTopology as JaxTierTopology
from repro.pool import auto_depth as jax_auto_depth
from repro.pool import default_pool as jax_default_pool
from repro_torch.pool import (
    PoolCapacityError,
    TierSpec,
    TierTopology,
    TransferEngine,
    auto_depth,
    default_pool,
)
from repro_torch.pool import backend as B


def _arrays(kb, fill):
    """One KiB-sized fp32 payload for each side."""
    x = np.full((kb * 256,), fill, np.float32)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def _counts(snap):
    """A snapshot without what depends on timing: measured times, and how
    many transfers were in flight or already done when waited on."""
    out = {}
    for k, v in snap.items():
        if k == "reserved":   # the JAX pool's admission bookkeeping
            continue
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


def _drive(pool, arr, fetch):
    """One sequence of pool operations, ending in a put that cannot be
    honoured; ``fetch`` turns a fetched value into numpy and every fetch
    must give back what was stored."""
    # 3 KiB device tier, 4 KiB host tier, 3 KiB remote tier
    pool.put("a", arr(1, 1.0), "device", priority=0.0)
    pool.put("b", arr(1, 2.0), "device", priority=5.0)
    pool.put("c", arr(1, 3.0), "device", priority=0.0)
    pool.put("d", arr(2, 4.0), "device", priority=1.0)   # spills a, then c
    pool.put("e", arr(2, 5.0))                         # default store: host
    pool.put("f", arr(2, 6.0))                         # host full: a, c spill
    assert fetch(pool.get("a"))[0] == 1.0
    assert fetch(pool.prefetch("c").wait())[0] == 3.0
    handles = [pool.prefetch(k) for k in ("b", "d", "e", "f")]
    assert [fetch(h.wait())[0] for h in handles] == [2.0, 4.0, 5.0, 6.0]
    pool.put("e", arr(2, 7.0))                         # re-put in place
    assert fetch(pool.prefetch("e").wait())[0] == 7.0
    pool.drop("b")
    # d spills to the full host tier, whose LRU entry f cannot spill into
    # the remote tier (2 of its 3 KiB hold a and c): the chain is full
    pool.put("g", arr(3, 8.0), "device")


def test_pool_sequence_matches_jax_counts_bytes_and_evictions():
    kw = dict(device_capacity=3 * 1024, host_capacity=4 * 1024,
              remote_capacity=3 * 1024)
    jp = jax_default_pool(**kw)
    tp = default_pool(device="cpu", **kw)
    # both refuse g, and the failed put moves nothing
    with pytest.raises(JaxPoolCapacityError, match="last tier"):
        _drive(jp, lambda kb, f: _arrays(kb, f)[0], np.asarray)
    with pytest.raises(PoolCapacityError, match="last tier"):
        _drive(tp, lambda kb, f: _arrays(kb, f)[1], lambda t: t.numpy())
    assert _counts(tp.snapshot()) == _counts(jp.snapshot())
    for key in "acdef":
        assert tp.tier_of(key) == jp.tier_of(key)
        np.testing.assert_array_equal(tp.get(key).numpy(),
                                      np.asarray(jp.get(key)))
    assert [tp.tier_of(k) for k in "acdef"] == \
        ["remote", "remote", "device", "host", "host"]
    assert tp.snapshot()["evictions"] == 4
    tp.close()
    jp.close()


def test_topology_and_depth_policy_match_jax():
    jt, tt = JaxTierTopology.default(host_capacity=7), \
        TierTopology.default(host_capacity=7)
    assert jt.to_dict() == tt.to_dict()
    assert (jt.default_store_tier, jt.admission_tiers) == \
        (tt.default_store_tier, tt.admission_tiers)
    assert TierTopology.from_dict(tt.to_dict()) == tt
    for kw in ({}, {"layers": 32}, {"pages": 17}, {"layers": 2, "pages": 9}):
        assert auto_depth(**kw) == jax_auto_depth(**kw)
    with pytest.raises(ValueError):
        TierSpec("x", kind="host", read_bw=1.0)
    with pytest.raises(ValueError):
        JaxTierSpec("x", kind="host", read_bw=1.0)


def test_cpu_pool_backends_hold_snapshots():
    pool = default_pool(device="cpu")
    assert [pool.tiers[n].backend.name for n in pool.spill_order] == \
        ["device[cpu]", "host[cpu]", "modeled[remote]"]
    x = torch.arange(8.0)
    pool.put("x", x)
    x.zero_()                               # the pool kept its own copy
    y = pool.get("x")
    assert torch.equal(y, torch.arange(8.0))
    y.zero_()                               # and hands out a new tensor
    assert torch.equal(pool.get("x"), torch.arange(8.0))
    host = pool.tiers["host"].backend
    h = pool.entries["x"].handle
    pool.put("x", torch.ones(8))            # same shape: buffer reused
    assert pool.entries["x"].handle is h and host.holds(h)
    with pytest.raises(ValueError, match="copy stream"):
        B.HostBackend(torch.device("cuda"))


def test_transfer_depth_bounds_in_flight_and_counts_waits():
    eng = TransferEngine(depth=2, workers=2)
    gate = threading.Event()
    handles = [eng.submit(lambda i=i: (gate.wait(5), i)[1], key=str(i))
               for i in range(2)]
    assert eng.stats.max_in_flight == 2
    gate.set()
    third = eng.submit(lambda: 3, key="2")
    assert [h.wait() for h in handles] + [third.wait()] == [0, 1, 3]
    snap = eng.stats.snapshot()
    assert snap["issued"] == 3 and snap["completed"] == 3
    assert snap["waits_overlapped"] + snap["waits_blocked"] == 3
    assert snap["max_in_flight"] <= 2
    eng.close()


def test_a_fetch_racing_a_spill_counts_its_bytes_once_at_issue():
    """A prefetch whose worker is held back while its entry spills into an
    int8 host tier: the fetch is counted when it is issued, with the bytes
    of the tier it reads (the device copy it captured), and its worker adds
    nothing when it finally runs. The LRU clock moves at issue too, so the
    spill's victim does not depend on when the worker runs."""
    page = 4 * 256 * 4                     # a 4 KiB fp32 page
    pool = default_pool(device="cpu", device_capacity=2 * page,
                        codec="int8", transfer_workers=1)
    try:
        a = torch.arange(1024, dtype=torch.float32)
        pool.put("a", a, B.DEVICE_TIER)
        pool.put("b", a + 1, B.DEVICE_TIER)
        gate = threading.Event()
        blocker = pool.transfer.submit(gate.wait, key="gate")
        h = pool.prefetch("a")
        clock_at_issue = pool.entries["a"].last_use
        assert pool.stats.gets == 1 and pool.stats.bytes_fetched == page
        # "a" was touched by the issue, so the spill takes "b"; touch "b"
        # and spill again to push "a" down while its fetch is still queued
        pool.get("b")
        pool.put("c", a + 2, B.DEVICE_TIER)
        assert pool.entries["a"].tier == B.HOST_TIER
        assert pool.entries["a"].nbytes == 1024 + 4     # int8 + its scale
        gate.set()
        blocker.wait()
        assert torch.equal(h.wait(), a)
        assert pool.stats.gets == 2
        assert pool.stats.bytes_fetched == 2 * page
        assert pool.entries["a"].last_use == clock_at_issue
    finally:
        pool.close()
