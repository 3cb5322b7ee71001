"""The port's front door (``repro_torch.api``) against the JAX package's
(``repro.api``), on the CPU at smoke size.

``OffloadConfig`` serializes to the reference's JSON (``--print-config``
equals ``CONFIG_default.json`` in every key but ``hw``) and validates what
the reference validates. ``HyperOffloadSession`` wires one pool, one
transfer engine and one plan cache into every subsystem; driven like the
JAX session on the same parameters (converted with ``repro_torch.convert``)
and the same requests, its ``stats()`` equals the reference's in every key
and value but the measured times and the backends' names. The session's
training methods belong to the port's training slice and are not tested
here."""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.api
from repro import sched as jsched
from repro.api import HyperOffloadSession as JaxSession
from repro.api import OffloadConfig as JaxConfig
from repro.api.config import KVCodecConfig as JaxKVCodecConfig
from repro.api.config import PrefixCacheConfig as JaxPrefixCacheConfig
from repro.configs import REGISTRY as JAX_REGISTRY
from repro.models.model import build_model as jax_build_model
from repro.offload.kvcache import worst_case_page_bytes as jax_row_bytes
from repro.pool import TierTopology as JaxTierTopology
from repro.pool import sweep_topologies as jax_sweep_topologies
from repro_torch import sched as tsched
from repro_torch.api import HyperOffloadSession, OffloadConfig
from repro_torch.api.__main__ import main as api_main
from repro_torch.api.config import (
    CalibrationConfig, KVCodecConfig, PrefixCacheConfig,
)
from repro_torch.configs import REGISTRY
from repro_torch.convert import params_from_numpy
from repro_torch.core.calibration import (
    CalibratedHardwareSpec, measurements_from_pairs,
)
from repro_torch.core.costmodel import HardwareSpec
from repro_torch.core.insertion import PAGED_INSERTION, InsertionOptions
from repro_torch.core.schedule import ScheduleOptions
from repro_torch.launch.serve import main as serve_main
from repro_torch.models.model import build_model
from repro_torch.offload.kvcache import PagedKVCache
from repro_torch.pool import (
    TierSpec, TierTopology, auto_depth, default_pool, sweep_topologies,
)
from repro_torch.sched import ContinuousScheduler, Request, SchedulerConfig
from repro_torch.serving.engine import ServeEngine

ARCH = "phi3-mini-3.8b"
CFG = REGISTRY[ARCH].reduced()
MAX_SEQ = 32
CPU = "cpu"
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX params, port model, port params): the port's
    parameters converted from the JAX model's."""
    jm = jax_build_model(JAX_REGISTRY[ARCH].reduced())
    jp = jm.init(jax.random.key(0))
    tm = build_model(CFG)
    return jm, jp, tm, params_from_numpy(jax.tree.map(np.asarray, jp), CPU)


@pytest.fixture(scope="module")
def model_and_params(pair):
    return pair[2], pair[3]


def _session(cfg=None, **kw):
    return HyperOffloadSession(cfg, device=CPU, **kw)


# ---------------------------------------------------------------------------
# public surface + config serialization
# ---------------------------------------------------------------------------


def test_public_api_surface_is_pinned():
    assert repro_torch.api.__all__ == [
        "KVCodecConfig",
        "OffloadConfig",
        "HyperOffloadSession",
        "HW_SPECS",
        "MODES",
    ]
    assert sorted(repro_torch.api.HW_SPECS) == \
        ["ascend_910c_like", "h100_sxm", "tpu_v5e"]
    assert OffloadConfig().hw == "h100_sxm"


def _full_config(cfg_cls, ins_cls, sched_cls):
    return cfg_cls(
        mode="kv_offload", hw="ascend_910c_like",
        device_capacity=1 << 20, host_capacity=1 << 22, transfer_depth=16,
        max_seq=64, max_batch=2, prefill_budget=2, chunk_size=16,
        prefill_tokens=32, cache_dtype="bfloat16",
        insertion=ins_cls(min_bytes=4096, force_prefixes=("kv_",)),
        schedule=sched_cls(max_candidates=8),
        remat="offload", offload_opt_state=True)


def test_config_round_trips_through_json_as_the_reference_does():
    from repro.core.insertion import InsertionOptions as JaxIns
    from repro.core.schedule import ScheduleOptions as JaxSched
    cfg = _full_config(OffloadConfig, InsertionOptions, ScheduleOptions)
    wire = json.loads(json.dumps(cfg.to_dict()))
    assert OffloadConfig.from_dict(wire) == cfg
    assert wire == json.loads(json.dumps(
        _full_config(JaxConfig, JaxIns, JaxSched).to_dict()))
    assert cfg.dtype == torch.bfloat16
    assert OffloadConfig().dtype == torch.float32
    with pytest.raises(ValueError, match="cache_dtype"):
        OffloadConfig(cache_dtype="float8")


def test_config_round_trips_custom_hardware():
    hw = HardwareSpec(name="lab_box", flops=1e12, hbm_bw=1e11,
                      hbm_bytes=8e9, pool_bw_d2r=1e10, pool_bw_r2d=1e10,
                      link_bw=1e10)
    cfg = OffloadConfig(hw=hw)
    back = OffloadConfig.from_dict(json.loads(json.dumps(cfg.to_dict())))
    assert back.hardware == hw
    # a registered spec serializes compactly, by name
    for name in ("tpu_v5e", "h100_sxm"):
        assert OffloadConfig(hw=name).to_dict()["hw"] == name
        assert OffloadConfig(hw=repro_torch.api.HW_SPECS[name]).to_dict()[
            "hw"] == name


def _refusals(cfg_cls, from_dict):
    out = {}
    cases = {"mode": dict(mode="turbo"), "remat": dict(remat="sometimes"),
             "hw": dict(hw="abacus"), "depth": dict(transfer_depth=0),
             "chunk0": dict(chunk_size=0),
             "chunk-max": dict(chunk_size=256, max_seq=128),
             "budget": dict(prefill_tokens=16),
             "prefix-mode": dict(mode="paged", chunk_size=8,
                                 prefix_cache=True),
             "slo-mode": dict(mode="paged", slo=True)}
    for name, kw in cases.items():
        if kw.pop("prefix_cache", False):
            kw["prefix_cache"] = (PrefixCacheConfig if cfg_cls is
                                  OffloadConfig else
                                  JaxPrefixCacheConfig)(enable=True)
        if kw.pop("slo", False):
            from repro.slo.policy import SLOConfig as JaxSLO
            from repro_torch.slo.policy import SLOConfig as TorchSLO
            kw["slo"] = (TorchSLO if cfg_cls is OffloadConfig
                         else JaxSLO)(enable=True)
        with pytest.raises(ValueError) as e:
            cfg_cls(**kw)
        out[name] = str(e.value)
    for name, d in (("typo", {"modee": "resident"}),
                    ("nested-typo", {"insertion": {"min_byte": 4096}})):
        with pytest.raises(ValueError) as e:
            from_dict(d)
        out[name] = str(e.value)
    return out


def test_config_validates_fields_as_the_reference_does():
    te = _refusals(OffloadConfig, OffloadConfig.from_dict)
    je = _refusals(JaxConfig, JaxConfig.from_dict)
    assert te.keys() == je.keys()
    for name in te:
        if name == "hw":        # each lists its own registry
            assert "unknown hardware 'abacus'" in te[name]
            assert "h100_sxm" in te[name]
        else:
            assert te[name] == je[name], name


def test_mode_resolves_planner_and_depth_defaults():
    assert OffloadConfig(mode="paged").insertion_options() == PAGED_INSERTION
    assert OffloadConfig(mode="kv_offload").insertion_options().min_bytes == 1
    assert OffloadConfig().insertion_options().min_bytes == 1 << 20
    custom = InsertionOptions(min_bytes=7)
    assert OffloadConfig(mode="paged",
                         insertion=custom).insertion_options() is custom
    auto = OffloadConfig()
    assert auto.depth_for(layers=16) == auto_depth(layers=16) == 64
    assert auto.depth_for(pages=40) == 80
    assert auto.depth_for() == 8                       # floor
    assert OffloadConfig(transfer_depth=3).depth_for(pages=1000) == 3
    for mode in ("resident", "kv_offload", "paged", "continuous"):
        assert dataclasses.asdict(OffloadConfig(
            mode=mode).insertion_options()) == dataclasses.asdict(
                JaxConfig(mode=mode).insertion_options())


def test_kv_offload_override_keeps_mandatory_prefetch_planning(
        model_and_params):
    model, params = model_and_params
    session = _session(OffloadConfig(max_seq=32, max_batch=2))
    sched = session.scheduler(model, params, kv_offload=True)
    assert sched.cfg.insert_opts == PAGED_INSERTION
    assert sched.prefetcher is not None
    assert len(sched.prefetcher.planned_layers) > 0
    session.close()


def test_print_config_cli(capsys):
    assert api_main(["--print-config"]) == 0
    dumped = json.loads(capsys.readouterr().out)
    assert dumped["mode"] == "resident"
    assert dumped["transfer_depth"] == "auto"
    resolved = dumped.pop("insertion_resolved")
    topo = dumped.pop("topology_resolved")
    assert OffloadConfig.from_dict(dumped) == OffloadConfig()
    assert resolved["min_bytes"] == \
        OffloadConfig().insertion_options().min_bytes
    assert [t["name"] for t in topo["tiers"]] == ["device", "host", "remote"]
    assert api_main([]) == 2
    capsys.readouterr()


@pytest.mark.parametrize("mode", [None, "resident", "kv_offload", "paged",
                                  "continuous"])
def test_print_config_equals_the_reference_but_hw(capsys, mode):
    from repro.api.__main__ import main as jax_api_main
    argv = ["--print-config"] + ([] if mode is None else ["--mode", mode])
    assert api_main(argv) == 0
    ours = json.loads(capsys.readouterr().out)
    assert jax_api_main(argv) == 0
    ref = json.loads(capsys.readouterr().out)
    assert ours.pop("hw") == "h100_sxm" and ref.pop("hw") == "tpu_v5e"
    assert ours == ref
    if mode is None:
        committed = json.loads((ROOT / "CONFIG_default.json").read_text())
        committed.pop("hw")
        assert ours == committed


def test_config_topology_roundtrip_and_validation():
    topo = TierTopology(tiers=(
        TierSpec("device", kind="device", capacity=1 << 20),
        TierSpec("host", kind="host", capacity=1 << 22),
        TierSpec("cxl", kind="modeled", read_bw=5e9, write_bw=4e9,
                 read_latency_s=1e-4, admit=False),
    ))
    cfg = OffloadConfig(mode="kv_offload", topology=topo,
                        calibration=CalibrationConfig(min_transfers=4,
                                                      max_inflight=32))
    back = OffloadConfig.from_dict(json.loads(json.dumps(cfg.to_dict())))
    assert back == cfg and back.tier_topology == topo
    d = OffloadConfig(host_capacity=1 << 20)
    assert d.tier_topology.names == ("device", "host", "remote")
    assert d.tier_topology.spec("host").capacity == 1 << 20
    with pytest.raises(ValueError, match="TierTopology"):
        OffloadConfig(topology={"tiers": []})
    with pytest.raises(ValueError, match="capacities"):
        OffloadConfig(topology=topo, host_capacity=1 << 20)
    with pytest.raises(ValueError, match="pin_tier"):
        OffloadConfig(mode="continuous", chunk_size=8, topology=topo,
                      prefix_cache=PrefixCacheConfig(enable=True,
                                                     pin_tier="remote"))
    with pytest.raises(ValueError, match="accelerator"):
        OffloadConfig(kv_codec=KVCodecConfig(codec="int8",
                                             below_tier="device"))
    with pytest.raises(ValueError, match="not a tier"):
        OffloadConfig(kv_codec=KVCodecConfig(codec="int8", below_tier="cxl"))
    with pytest.raises(ValueError, match="kv_codec.codec"):
        KVCodecConfig(codec="zstd")
    OffloadConfig(topology=TierTopology(tiers=(TierSpec("ram",
                                                        kind="numpy"),)))
    with pytest.raises(ValueError, match="min_transfers"):
        CalibrationConfig(min_transfers=0)
    with pytest.raises(ValueError, match="max_inflight"):
        CalibrationConfig(max_inflight=0)


def test_sweep_topologies_equals_the_reference():
    bws = [5e9, 20e9, 70e9]
    ours = sweep_topologies(TierTopology.default(), "remote",
                            read_bws=bws)
    ref = jax_sweep_topologies(JaxTierTopology.default(), "remote",
                               read_bws=bws)
    assert [t.to_dict() for t in ours] == [t.to_dict() for t in ref]
    with pytest.raises(ValueError, match="modeled"):
        sweep_topologies(TierTopology.default(), "host", read_bws=bws)


def test_page_table_prefetch_tiers_and_pool_tracer():
    """``KVPageTable.prefetch``/``tiers`` and ``MemoryPoolManager.set_tracer``
    (members the session and later slices call): pages park, spill and
    come back as in the reference's table."""
    from repro.offload.kvcache import KVPageTable as JaxKVPageTable
    from repro.pool import default_pool as jax_default_pool
    from repro_torch.obs import Tracer
    from repro_torch.offload.kvcache import KVPageTable
    rng = np.random.default_rng(8)
    pages = [rng.standard_normal(64).astype(np.float32) for _ in range(3)]
    caps = dict(device_capacity=2 * 256, host_capacity=1 << 20)
    pool, jpool = default_pool(device=CPU, **caps), jax_default_pool(**caps)
    tracer = Tracer()
    pool.set_tracer(tracer)
    assert pool.transfer.tracer is tracer
    table, jtable = KVPageTable(pool, "r"), JaxKVPageTable(jpool, "r")
    for i, page in enumerate(pages):
        table.park(f"L{i}", torch.from_numpy(page), "device", priority=i)
        jtable.park(f"L{i}", jnp.asarray(page), "device", priority=i)
    assert table.tiers() == jtable.tiers() == \
        {"L0": "host", "L1": "device", "L2": "device"}
    for i, page in enumerate(pages):
        np.testing.assert_array_equal(table.prefetch(f"L{i}").wait().numpy(),
                                      page)
    assert {e.name for e in tracer.events()} >= {"put", "spill", "transfer"}
    pool.set_tracer(None)
    assert not pool.tracer.enabled and not pool.transfer.tracer.enabled
    table.drop()
    assert table.tiers() == {}
    pool.close()
    jpool.close()


# ---------------------------------------------------------------------------
# session wiring
# ---------------------------------------------------------------------------


def test_session_shares_one_pool_and_merges_stats(model_and_params):
    model, params = model_and_params
    cfg = OffloadConfig(mode="kv_offload", max_seq=MAX_SEQ, max_batch=2)
    with _session(cfg) as session:
        engine = session.serve_engine(model, params)
        sched = session.scheduler(model, params)
        cache = session.paged_kv(batch=1, n_kv_heads=CFG.n_kv_heads,
                                 head_dim=CFG.head_dim)
        assert engine.pool is session.pool
        assert sched.pool is session.pool
        assert cache.pool is session.pool
        assert session.transfer is session.pool.transfer
        assert session.pool.device == torch.device("cpu")
        out = engine.generate({"tokens": torch.ones((1, 4),
                                                    dtype=torch.int32)}, 3)
        assert out.shape == (1, 3)
        sched.run([Request(tokens=np.ones((4,), np.int32),
                           max_new_tokens=4, seed=0)])
        s = session.stats()
        assert s["mode"] == "kv_offload"
        assert s["serve"]["engines"] == 1
        assert s["serve"]["decoded_tokens"] == 2
        assert s["serve"]["cache_round_trips"] == 2
        assert s["sched"]["schedulers"] == 1
        assert s["sched"]["retires"] == 1
        assert s["sched"]["prefetch"]["fetches_issued"] > 0
        assert s["paged"]["caches"] == 1
        assert s["pool"]["puts"] > 0 and "transfer" in s["pool"]
        assert s["plans_cached"] == 1
    session.close()         # idempotent


def test_a_closed_session_and_what_it_handed_out_die_without_the_collector(
        model_and_params):
    """The registry's collectors hold the session weakly: once closed and
    dropped, the session, its engine, scheduler (which shares the
    session's registry under telemetry) and paged cache are freed by
    reference counting alone, with the collector off."""
    import gc
    import weakref
    model, params = model_and_params
    gc.collect()
    gc.disable()
    try:
        from repro_torch.api.config import TelemetryConfig
        session = _session(OffloadConfig(
            mode="kv_offload", max_seq=MAX_SEQ, max_batch=2,
            telemetry=TelemetryConfig(enable=True)))
        engine = session.serve_engine(model, params)
        engine.generate({"tokens": torch.ones((1, 4), dtype=torch.int32)}, 3)
        sched = session.scheduler(model, params)
        sched.run([Request(tokens=np.ones((4,), np.int32), max_new_tokens=4,
                           seed=0)])
        paged = session.paged_kv(batch=1, n_kv_heads=CFG.n_kv_heads,
                                 head_dim=CFG.head_dim)
        assert session.stats()["serve"]["engines"] == 1
        refs = [weakref.ref(o) for o in (session, engine, sched, paged)]
        session.close()
        del session, engine, sched, paged
        assert [r() is None for r in refs] == [True] * 4
    finally:
        gc.enable()


def test_engine_and_paged_cache_close_leave_the_pool_open(model_and_params):
    """``ServeEngine.close`` and ``PagedKVCache.close`` are idempotent and
    leave the (caller-provided) pool to its owner: it still parks a value
    on the host and fetches it back. ``HyperOffloadSession.close`` closes
    every engine it handed out, as the reference's session does."""
    model, params = model_and_params
    pool = default_pool(device=CPU, device_capacity=1 << 20,
                        host_capacity=1 << 20)
    engine = ServeEngine(model, params, max_seq=MAX_SEQ, offload_kv=True,
                         pool=pool)
    cache = PagedKVCache.create(batch=1, max_seq=MAX_SEQ, page_size=8,
                                n_kv_heads=CFG.n_kv_heads,
                                head_dim=CFG.head_dim, pool=pool)
    assert not engine._closed
    for _ in range(2):
        engine.close()
        cache.close()
    assert engine._closed
    value = torch.arange(16, dtype=torch.float32)
    pool.put("after-close", value, tier="host")
    assert torch.equal(pool.get("after-close"), value)
    pool.close()

    cfg = OffloadConfig(mode="kv_offload", max_seq=MAX_SEQ, max_batch=2)
    session = _session(cfg)
    engines = [session.serve_engine(model, params),
               session.serve_engine(model, params, offload_kv=False)]
    assert not any(e._closed for e in engines)
    session.close()
    assert all(e._closed for e in engines)
    session.close()         # idempotent


def test_session_plan_cache_is_shared(model_and_params):
    model, params = model_and_params
    cfg = OffloadConfig(mode="kv_offload", max_seq=MAX_SEQ, max_batch=2)
    with _session(cfg) as session:
        s1 = session.scheduler(model, params)
        s2 = session.scheduler(model, params)
        assert s1.prefetcher.plan is s2.prefetcher.plan
        assert session.stats()["plans_cached"] == 1
        # plan() memoizes under a key in the same cache
        g = s1.prefetcher.plan.graph
        p = session.plan(g, key="g")
        assert session.plan(g, key="g") is p
        assert session.stats()["plans_cached"] == 2


def test_session_auto_depth_grows_pinned_does_not(model_and_params):
    with _session(OffloadConfig(mode="kv_offload",
                                max_seq=MAX_SEQ)) as session:
        base = session.transfer.depth
        session.paged_kv(batch=1, n_kv_heads=CFG.n_kv_heads,
                         head_dim=CFG.head_dim, max_seq=256, page_size=4)
        assert session.transfer.depth == max(base, 2 * (256 // 4))
    with _session(OffloadConfig(mode="kv_offload", max_seq=MAX_SEQ,
                                transfer_depth=5)) as session:
        session.paged_kv(batch=1, n_kv_heads=CFG.n_kv_heads,
                         head_dim=CFG.head_dim, max_seq=256, page_size=4)
        assert session.transfer.depth == 5
    # the pin applies to an injected pool too
    ext = default_pool(transfer_depth=5, device=CPU)
    session = HyperOffloadSession(
        OffloadConfig(mode="kv_offload", max_seq=MAX_SEQ, transfer_depth=5),
        pool=ext)
    session.paged_kv(batch=1, n_kv_heads=CFG.n_kv_heads,
                     head_dim=CFG.head_dim, max_seq=256, page_size=4)
    assert ext.transfer.depth == 5
    session.close()
    ext.close()


def test_session_scheduler_overrides(model_and_params):
    model, params = model_and_params
    cfg = OffloadConfig(mode="continuous", max_seq=MAX_SEQ, max_batch=4)
    with _session(cfg) as session:
        sched = session.scheduler(model, params, max_batch=2,
                                  prefill_budget=2)
        assert sched.cfg.max_batch == 2
        assert sched.cfg.prefill_budget == 2
        assert sched.cfg.kv_offload is False              # continuous = resident
        assert sched.cfg.hw is session.hw and sched.cfg.hw.name == "h100_sxm"
        with pytest.raises(TypeError, match="not both"):
            session.scheduler(model, params, SchedulerConfig(), max_batch=2)


def test_default_topology_is_behaviorally_identical(model_and_params):
    model, params = model_and_params
    batch = {"tokens": torch.ones((2, 4), dtype=torch.int32)}
    for mode in ("resident", "kv_offload"):
        outs, shapes = [], []
        for topo in (None, TierTopology.default()):
            cfg = OffloadConfig(mode=mode, max_batch=2, max_seq=MAX_SEQ,
                                topology=topo)
            with _session(cfg) as s:
                outs.append(s.serve_engine(model, params).generate(batch, 6))
                st = s.stats()
                shapes.append((sorted(st), sorted(st["pool"])))
        assert torch.equal(outs[0], outs[1])
        assert shapes[0] == shapes[1]


def test_recalibrate_replans_from_measured_bandwidth(model_and_params):
    model, params = model_and_params
    cfg = OffloadConfig(mode="kv_offload", max_batch=2, max_seq=MAX_SEQ)
    with _session(cfg) as s:
        sched = s.scheduler(model, params)
        sched.run([Request(tokens=np.ones((6,), np.int32),
                           max_new_tokens=4, seed=0)])
        s.serve_engine(model, params).generate(
            {"tokens": torch.ones((2, 4), dtype=torch.int32)}, 4)
        static = s.hw
        ms = measurements_from_pairs(s.transfer.stats.snapshot()["pairs"])
        spec = s.recalibrate()
        assert isinstance(spec, CalibratedHardwareSpec)
        assert spec.name == f"{static.name}+measured" == "h100_sxm+measured"
        reads = [m for (src, dst), m in ms.items()
                 if dst == "device" and src != "device"
                 and m.transfers >= 2 and m.nbytes >= 1024]
        assert reads, "serving must have produced eligible read traffic"
        expect = (sum(m.nbytes for m in reads)
                  / sum(m.busy_s for m in reads))
        assert spec.pool_bw_r2d == pytest.approx(expect)
        assert spec.pool_bw_r2d != static.pool_bw_r2d
        for m in reads:
            assert spec.bandwidth_between(m.src, m.dst) == pytest.approx(
                m.bandwidth)
        assert s.planner.hw is spec
        assert sched.cfg.hw is spec
        assert sched.prefetcher is not None
        assert s.recalibrate().name == f"{static.name}+measured"


def test_offload_construction_requires_explicit_pool(model_and_params):
    model, params = model_and_params
    with pytest.raises(ValueError, match="HyperOffloadSession"):
        ServeEngine(model, params, max_seq=MAX_SEQ, offload_kv=True)
    with pytest.raises(ValueError, match="HyperOffloadSession"):
        ContinuousScheduler(
            model, params,
            SchedulerConfig(max_batch=2, max_seq=MAX_SEQ, kv_offload=True))
    with pytest.raises(ValueError, match="HyperOffloadSession"):
        PagedKVCache.create(batch=1, max_seq=64, page_size=16,
                            n_kv_heads=2, head_dim=8)


def test_session_construction_does_not_warn(model_and_params):
    import warnings
    model, params = model_and_params
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        with _session(OffloadConfig(mode="kv_offload",
                                    max_seq=MAX_SEQ)) as session:
            session.serve_engine(model, params)
            session.scheduler(model, params)
            session.paged_kv(batch=1, n_kv_heads=CFG.n_kv_heads,
                             head_dim=CFG.head_dim)


def test_session_needs_cuda_unless_asked_for_the_cpu():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            HyperOffloadSession(OffloadConfig())


# ---------------------------------------------------------------------------
# the session against the JAX session
# ---------------------------------------------------------------------------


def _mixed_trace(pkg, vocab):
    """``tests/test_sched.py``'s mixed trace, built with ``pkg.Request``."""
    rng = np.random.default_rng(0)
    shapes = [(5, 6, 0.0), (9, 3, 0.0), (3, 8, 2.0), (7, 1, 4.0), (4, 5, 4.0)]
    return [pkg.Request(tokens=rng.integers(0, vocab, size=s, dtype=np.int32),
                        max_new_tokens=n, arrival=a, seed=i)
            for i, (s, n, a) in enumerate(shapes)]


#: stats() fields that depend on the host clock or the framework
_TIMING = ("blocked_s", "backpressure_s", "waits_overlapped",
           "waits_blocked", "backpressure_waits", "max_in_flight")
#: pool fields that depend on thread timing in the reference: its transfer
#: worker counts a fetch's bytes when the worker runs, so on a loaded
#: machine a spill that lands between a fetch's issue and its run shrinks
#: the count (the port counts each fetch when it is issued)
_POOL_TIMING = ("bytes_fetched",)


def _comparable(stats):
    out = json.loads(json.dumps(stats))
    for k in _POOL_TIMING:
        out["pool"].pop(k)
    tr = out["pool"]["transfer"]
    for k in _TIMING:
        tr.pop(k)
    for pair in tr["pairs"].values():
        pair.pop("busy_s")
    for k, v in out["pool"].items():
        if k.startswith("tier/"):
            v.pop("backend")
    return out


def _drive(session, model, params, pkg, page_inputs, tokens):
    """What each session runs: the mixed trace through a kv_offload
    scheduler, a short generate through a kv_offload engine, and a paged
    cache prefilled and attended over."""
    sched = session.scheduler(model, params)
    reqs = _mixed_trace(pkg, CFG.vocab_size)
    raw = sched.run(reqs)
    out = {r.seed: np.asarray(raw[r.req_id]).tolist() for r in reqs}
    gen = np.asarray(session.serve_engine(model, params).generate(
        {"tokens": tokens}, 4)).tolist()
    k, v, q = page_inputs
    cache = session.paged_kv(batch=2, n_kv_heads=2, head_dim=32, max_seq=64,
                             page_size=8, device_pages=4)
    cache.prefill(k, v)
    att = np.asarray(cache.attend_fused(q, scale=32 ** -0.5, top_k_pages=2))
    return out, gen, att


@pytest.mark.parametrize("codec", ["none", "int8"])
def test_session_stats_equal_the_reference(pair, codec):
    """Both sessions, driven alike (kv_offload, chunked prefill with the
    prefix cache on, a 1.5-row device tier that spills through the codec
    host tier, the reference's hardware numbers): the same tokens, and a
    ``stats()`` equal in every key and value but the measured times and
    the backends' names."""
    jm, jp, tm, tp = pair
    row = jax_row_bytes(jm.cache_specs(1, MAX_SEQ, np.float32))
    common = dict(mode="kv_offload", max_batch=2, max_seq=MAX_SEQ,
                  chunk_size=4, hw="tpu_v5e",
                  device_capacity=int(1.5 * row), host_capacity=8 * row)
    tcfg = OffloadConfig(prefix_cache=PrefixCacheConfig(enable=True,
                                                        page_size=4),
                         kv_codec=KVCodecConfig(codec=codec), **common)
    jcfg = JaxConfig(prefix_cache=JaxPrefixCacheConfig(enable=True,
                                                       page_size=4),
                     kv_codec=JaxKVCodecConfig(codec=codec), **common)
    rng = np.random.default_rng(4)
    pages = [rng.standard_normal(s).astype(np.float32)
             for s in ((2, 21, 2, 32), (2, 21, 2, 32), (2, 4, 32))]
    toks = rng.integers(0, CFG.vocab_size, (2, 4), dtype=np.int32)
    with _session(tcfg) as ts, JaxSession(jcfg) as js:
        tout = _drive(ts, tm, tp, tsched,
                      [torch.from_numpy(p) for p in pages],
                      torch.from_numpy(toks))
        jout = _drive(js, jm, jp, jsched, [jnp.asarray(p) for p in pages],
                      jnp.asarray(toks))
        assert tout[0] == jout[0]
        assert tout[1] == jout[1]
        np.testing.assert_allclose(tout[2], jout[2], atol=1e-5)
        tst, jst = ts.stats(), js.stats()
        assert list(tst) == list(jst)
        assert _comparable(tst) == _comparable(jst)
        assert tst["sched"]["cold_spills"] > 0
        host = tst["pool"]["tier/host"]["backend"]
        assert host == ("host[cpu]" if codec == "none" else "int8[host[cpu]]")
        assert ts.stats_text().splitlines()[:3] == \
            js.stats_text().splitlines()[:3]


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_serve_launcher_runs_on_the_cpu(capsys):
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--mode",
            "kv_offload", "--prompt-len", "6", "--new-tokens", "4",
            "--batch", "2", "--recalibrate"]
    assert serve_main(argv) == 0
    out = capsys.readouterr().out
    assert "tiers=device/host/remote" in out
    assert "recalibrated hw=h100_sxm+measured" in out
    assert "same_tokens=True" in out
    assert serve_main(argv[:5] + ["--remote-bw", "5"]) == 0
    assert "mode=resident" in capsys.readouterr().out
