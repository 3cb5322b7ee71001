"""The port's SLO layer (``repro_torch.slo``: ``GoodputController``,
``PreemptionEngine``) against the JAX package's (``repro.slo``), on the
CPU.

The policy objects are driven through the same scenarios in both packages
and must return the same victims, budgets, rates (the same floats) and
feasibility verdicts. Then the port's scheduler preempts a batch sequence
for an interactive arrival on a 1-slot batch — mid-decode and mid-prefill,
resident and ``kv_offload`` — and every request's tokens equal the JAX
scheduler's and an unpreempted batch-1 ``ServeEngine`` run's (greedy, so
exact); SLO admission never over-commits the pool's capacity.
"""

import jax
import numpy as np
import pytest
import torch

from repro import sched as jsched
from repro import slo as jslo
from repro.configs import REGISTRY as JAX_REGISTRY
from repro.models.model import build_model as jax_build_model
from repro.offload.kvcache import worst_case_page_bytes as jax_row_bytes
from repro.pool import TransferEngine as JaxTransferEngine
from repro.pool import default_pool as jax_default_pool
from repro_torch import sched as tsched
from repro_torch import slo as tslo
from repro_torch.configs import REGISTRY as TORCH_REGISTRY
from repro_torch.convert import params_from_numpy
from repro_torch.models.model import build_model as torch_build_model
from repro_torch.pool import default_pool as torch_default_pool
from repro_torch.serving.engine import ServeEngine

CPU = torch.device("cpu")
MAX_SEQ = 32
ARCH = "phi3-mini-3.8b"
PKGS = ((jsched, jslo), (tsched, tslo))


def _state(pkgs, cls=None, deadline=None, arrival=0.0, prompt=4, max_new=4,
           seed=0):
    sched, slo = pkgs
    spec = None if cls is None else slo.SLOSpec(cls, ttft_deadline=deadline)
    return sched.RequestState(request=sched.Request(
        tokens=np.ones((prompt,), np.int32), max_new_tokens=max_new,
        arrival=arrival, seed=seed, slo=spec))


def _both(scenario):
    """Run ``scenario(sched_module, slo_module)`` on each package; their
    records must agree."""
    jrec, trec = (scenario(*pkgs) for pkgs in PKGS)
    assert trec == jrec
    return trec


# ---------------------------------------------------------------------------
# policy objects
# ---------------------------------------------------------------------------


def test_pick_victim_policy_matches_the_reference():
    def scenario(sched, slo):
        pk = (sched, slo)
        eng = slo.PreemptionEngine(slo.SLOConfig(enable=True))
        eng.begin_step()
        remaining = lambda s: s.request.max_new_tokens - len(s.out)  # noqa
        batch_long = _state(pk, "batch", max_new=10, seed=1)
        batch_short = _state(pk, "batch", max_new=5, seed=2)
        running = [batch_short, batch_long]

        def pick(cand, run=running, now=4.0):
            v = eng.pick_victim(cand, run, now, est_prefill_steps=1.0,
                                remaining_steps=remaining)
            # by identity: dataclass equality would compare token arrays
            return next((i for i, s in enumerate(run) if s is v), None)

        rec = [
            # no TTFT deadline: pure-throughput work never preempts
            pick(_state(pk, "interactive", arrival=4.0)),
            # slack covers the earliest natural retirement
            pick(_state(pk, "interactive", 20.0, arrival=4.0)),
            # same class is never preempted
            pick(_state(pk, "interactive", 2.0, arrival=4.0),
                 [_state(pk, "interactive", 2.0, max_new=10)]),
        ]
        urgent = _state(pk, "interactive", 2.0, arrival=4.0)
        rec += [pick(urgent), pick(urgent)]     # the quota (1) is now spent
        eng.begin_step()
        rec.append(pick(urgent))
        off = slo.PreemptionEngine(slo.SLOConfig(enable=True,
                                                 preemption=False))
        off.begin_step()
        rec.append(off.pick_victim(
            _state(pk, "interactive", 1.0), [_state(pk, "batch", max_new=10)],
            5.0, est_prefill_steps=1.0, remaining_steps=lambda s: 10))
        return rec

    # the lowest class with the most remaining work is parked
    assert _both(scenario) == [None, None, None, 1, None, 1, None]


def test_boost_budget_matches_the_reference():
    def scenario(sched, slo):
        pk = (sched, slo)
        ctl = slo.GoodputController(slo.SLOConfig(enable=True,
                                                  max_prefill_boost=3.0))
        rec = [ctl.boost_budget(4, [_state(pk, "batch", prompt=24)], 0.0),
               ctl.boosted_steps]
        pressed = _state(pk, "interactive", 2.0, prompt=24)
        rec += [ctl.boost_budget(4, [pressed], 0.0), ctl.boosted_steps]
        hopeless = _state(pk, "interactive", 1.0, prompt=28)
        hopeless.request.arrival = -30.0    # the slack floor max(slack, 1)
        rec.append(ctl.boost_budget(4, [hopeless], 0.0))
        half = _state(pk, "interactive", 5.0, prompt=24)
        half.prefill_pos = 12
        rec += [ctl.boost_budget(4, [half, pressed], 1.5), ctl.snapshot()]
        return rec

    rec = _both(scenario)
    assert rec[:5] == [4, 0, 12, 1, 12]      # capped at ceil(4 * 3.0)


def test_goodput_rate_matches_the_reference():
    def scenario(sched, slo):
        ctl = slo.GoodputController(slo.SLOConfig(enable=True))
        rec = [ctl.rate(4)]
        for landed in (16, 0, 2, 7, 33, 1, 0, 12):
            ctl.note_step(landed)
            rec.append(ctl.rate(4))
        return rec

    rec = _both(scenario)
    assert rec[:3] == [4.0, 16.0, 16.0] and min(rec) >= 4.0


def test_infeasible_matches_the_reference():
    def scenario(sched, slo):
        pk = (sched, slo)
        ctl = slo.GoodputController(slo.SLOConfig(enable=True))
        doomed = _state(pk, "interactive", 1.0)
        off = slo.GoodputController(slo.SLOConfig(enable=True,
                                                  shed_infeasible=False))
        return [ctl.infeasible(doomed, 5.0, est_prefill_steps=1.0),
                ctl.infeasible(doomed, 0.0, est_prefill_steps=1.0),
                ctl.infeasible(doomed, 0.0, est_prefill_steps=2.5),
                ctl.infeasible(_state(pk, "batch"), 5.0,
                               est_prefill_steps=1.0),
                off.infeasible(doomed, 5.0, est_prefill_steps=1.0)]

    assert _both(scenario) == [True, False, True, False, False]


# ---------------------------------------------------------------------------
# preempt / resume token identity
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    jm = jax_build_model(JAX_REGISTRY[ARCH].reduced())
    tm = torch_build_model(TORCH_REGISTRY[ARCH].reduced())
    jp = jm.init(jax.random.key(0))
    return jm, jp, tm, params_from_numpy(jax.tree.map(np.asarray, jp), CPU)


def _requests(pkgs, vocab, kind):
    """A batch request and an interactive arrival that must preempt it on a
    1-slot batch: mid-decode, or mid-prefill (a 24-token prompt in chunks
    of 4)."""
    sched, slo = pkgs
    if kind == "decode":
        rng = np.random.default_rng(10)
        shapes = ((5, 10, 0.0, slo.SLOSpec("batch")),
                  (4, 3, 3.0, slo.SLOSpec("interactive", ttft_deadline=2.0)))
    else:
        rng = np.random.default_rng(11)
        shapes = ((24, 4, 0.0, slo.SLOSpec("batch")),
                  (4, 3, 2.0, slo.SLOSpec("interactive", ttft_deadline=6.0)))
    return [sched.Request(tokens=rng.integers(0, vocab, n, dtype=np.int32),
                          max_new_tokens=new, arrival=t, seed=i, slo=spec)
            for i, (n, new, t, spec) in enumerate(shapes)]


def _pool(jax_side, row, kv_offload):
    if not kv_offload:
        return None
    caps = dict(device_capacity=int(1.5 * row), host_capacity=4 * row)
    if jax_side:
        return jax_default_pool(transfer=JaxTransferEngine(depth=64), **caps)
    return torch_default_pool(device="cpu", transfer_depth=64, **caps)


@pytest.mark.parametrize("kv_offload", [False, True],
                         ids=["resident", "kv_offload"])
@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_preempted_request_is_token_identical(pair, kind, kv_offload):
    jm, jp, tm, tp = pair
    row = jax_row_bytes(jm.cache_specs(1, MAX_SEQ, np.float32))
    chunk = dict(chunk_size=4) if kind == "prefill" else {}
    runs = []
    for (sched, slo), model, params in zip(PKGS, (jm, tm), (jp, tp)):
        pool = _pool(sched is jsched, row, kv_offload)
        s = sched.ContinuousScheduler(
            model, params,
            sched.SchedulerConfig(max_batch=1, max_seq=MAX_SEQ,
                                  kv_offload=kv_offload,
                                  slo=slo.SLOConfig(enable=True), **chunk),
            pool=pool)
        reqs = _requests((sched, slo), tm.cfg.vocab_size, kind)
        for r in reqs:
            s.submit(r)
        # step until the preemption, to see what the victim was doing
        while s.stats.preemptions == 0:
            s.step()
            assert s.stats.steps < 20, "expected a preemption"
        victim = s.preempted[0]
        parked = (victim.t_first_token is not None, victim.prefill_pos,
                  victim.status)
        out = s.run()
        runs.append(dict(
            tokens=[out[r.req_id].tolist() for r in reqs], parked=parked,
            stats=s.stats.__dict__.copy(), slo=s.slo_snapshot(),
            status=[s.finished[r.req_id].status for r in reqs],
            preemptions=[s.finished[r.req_id].preemptions for r in reqs],
            ttft=[s.finished[r.req_id].t_first_token - r.arrival
                  for r in reqs]))
        s.close()
        if pool is not None:
            pool.close()
    jrun, trun = runs
    assert trun == jrun
    assert trun["stats"]["preemptions"] >= 1 and trun["stats"]["resumes"] >= 1
    assert trun["stats"]["shed"] == 0
    assert trun["status"] == [tsched.DONE, tsched.DONE]
    assert trun["preemptions"][0] >= 1
    decoding, pos, status = trun["parked"]
    assert status == tsched.PREEMPTED
    if kind == "decode":
        assert decoding and trun["ttft"][1] <= 2.0    # the deadline held
    else:
        assert not decoding and 0 < pos < 24          # mid-chunk-walk
    eng = ServeEngine(tm, tp, max_seq=MAX_SEQ)
    for r, got in zip(_requests(PKGS[1], tm.cfg.vocab_size, kind),
                      trun["tokens"]):
        want = eng.generate({"tokens": torch.from_numpy(r.tokens)[None]},
                            r.max_new_tokens)[0].tolist()
        assert got == want


def test_admission_never_overcommits_with_slo(pair):
    """Preempted sequences keep their reservations, so the reserved bytes
    never exceed the device+host capacity and nothing spills to remote; the
    run's counters equal the reference's."""
    jm, jp, tm, tp = pair
    row = jax_row_bytes(jm.cache_specs(1, MAX_SEQ, np.float32))
    caps = dict(device_capacity=row, host_capacity=row)
    runs = []
    for (sched, slo), model, params in zip(PKGS, (jm, tm), (jp, tp)):
        if sched is jsched:
            pool = jax_default_pool(transfer=JaxTransferEngine(depth=64),
                                    **caps)
        else:
            pool = torch_default_pool(device="cpu", transfer_depth=64,
                                      **caps)
        reqs = sched.poisson_trace(6, rate=5.0, vocab_size=tm.cfg.vocab_size,
                                   prompt_lens=(4, 8), new_tokens=(3, 8),
                                   prompt_quantum=4, interactive_fraction=0.5,
                                   seed=0)
        s = sched.ContinuousScheduler(
            model, params,
            sched.SchedulerConfig(max_batch=3, max_seq=MAX_SEQ,
                                  kv_offload=True,
                                  slo=slo.SLOConfig(enable=True)),
            pool=pool)
        for r in reqs:
            s.submit(r)
        reserved = []
        while len(s.queue) or s.active or s.preempted:
            if (not s.active and not s.preempted
                    and s.queue.head_ready(s.now) is None):
                s.now = max(s.now, s.queue.next_arrival())
            s.step()
            reserved.append(pool.reserved_bytes())
            assert reserved[-1] <= 2 * row
            assert pool.occupancy("remote")[0] == 0
        runs.append(dict(reserved=reserved, stats=s.stats.__dict__.copy(),
                         slo=s.slo_snapshot(),
                         tokens=[s.finished[r.req_id].tokens_array().tolist()
                                 for r in reqs]))
        s.close()
        pool.close()
    assert runs[1] == runs[0]
