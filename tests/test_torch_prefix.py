"""The port's prefix cache (``repro_torch.prefix``) against the JAX
package's (``repro.prefix``), on the CPU.

The radix index and the cache manager are driven through the same
operations in both packages — donate, lookup, release, the ``max_pages``
budget, pool pressure on ref'd (pinned) pages and the ``pin_tier`` floor —
and must give the same answers, the same ``PrefixCacheStats`` and the same
pool counts. Then the port's scheduler serves a shared-prefix trace with a
prefix cache, resident and ``kv_offload`` under device pressure: tokens,
hits and prefill savings equal the JAX scheduler's, and the tokens equal
the port's batch-1 ``ServeEngine`` (greedy, so exact).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import prefix as jprefix
from repro import sched as jsched
from repro.configs import REGISTRY as JAX_REGISTRY
from repro.models.model import build_model as jax_build_model
from repro.offload.kvcache import worst_case_page_bytes as jax_row_bytes
from repro.pool import PoolCapacityError as JaxPoolCapacityError
from repro.pool import TransferEngine as JaxTransferEngine
from repro.pool import default_pool as jax_default_pool
from repro_torch import prefix as tprefix
from repro_torch import sched as tsched
from repro_torch.configs import REGISTRY as TORCH_REGISTRY
from repro_torch.convert import params_from_numpy
from repro_torch.models.model import build_model as torch_build_model
from repro_torch.pool import PoolCapacityError as TorchPoolCapacityError
from repro_torch.pool import default_pool as torch_default_pool
from repro_torch.serving.engine import ServeEngine

CPU = torch.device("cpu")
MAX_SEQ = 32
ARCH = "phi3-mini-3.8b"


def _toks(*ids):
    return np.asarray(ids, np.int32)


class _Side:
    """One package's constructors, so a scenario runs unchanged on both."""

    def __init__(self, name):
        self.name = name
        self.jax = name == "jax"
        self.prefix = jprefix if self.jax else tprefix
        self.capacity_error = (JaxPoolCapacityError if self.jax
                               else TorchPoolCapacityError)

    def pool(self, **kw):
        if self.jax:
            return jax_default_pool(**kw)
        return torch_default_pool(device="cpu", **kw)

    def page(self, kb, fill=1.0):
        """A ``kb`` KiB fp32 page filled with ``fill``."""
        if self.jax:
            return jnp.full((kb * 256,), fill, jnp.float32)
        return torch.full((kb * 256,), fill, dtype=torch.float32)

    def donate(self, mgr, tokens, n_pages, kb=256):
        return mgr.donate(np.asarray(tokens, np.int32), n_pages,
                          lambda p: {"L0.0": self.page(kb, float(p))})


SIDES = (_Side("jax"), _Side("torch"))


def _both(scenario):
    """Run ``scenario(side)`` on each package; their records must agree."""
    jrec, trec = (scenario(side) for side in SIDES)
    assert trec == jrec
    return trec


def _counts(pool):
    snap = pool.snapshot()
    out = {k: snap[k] for k in ("puts", "evictions", "drops", "bytes_stored",
                                "bytes_evicted")}
    for k, v in snap.items():
        if k.startswith("tier/"):
            out[k] = {kk: vv for kk, vv in v.items() if kk != "backend"}
    return out


# ---------------------------------------------------------------------------
# radix index
# ---------------------------------------------------------------------------


def _shape(nodes):
    """Nodes by what they are (depth, page tokens), not by their ids, which
    come from a per-package counter."""
    return [(n.depth, n.page_key, n.refs) for n in nodes]


def test_radix_match_insert_remove_matches_the_reference():
    def scenario(side):
        rec = []
        idx = side.prefix.RadixPrefixIndex(page_size=2)
        rec.append(_shape(idx.match(_toks(1, 2, 3, 4))))
        chain, created = idx.insert(_toks(1, 2, 3, 4), 2)
        rec.append((_shape(chain), _shape(created), len(idx)))
        for toks, cap in (((1, 2, 3, 4, 9, 9), None), ((1, 2, 9, 9), None),
                          ((9, 9, 3, 4), None), ((1, 2, 3), None),
                          ((1, 2, 3, 4), 1)):
            rec.append(_shape(idx.match(_toks(*toks), max_pages=cap)))
        chain2, created2 = idx.insert(_toks(1, 2, 3, 4, 5, 6), 3)
        assert chain2[:2] == chain and created2 == chain2[2:]
        rec.append((_shape(chain2), _shape(created2), len(idx)))
        removed = idx.remove(chain[1])
        rec.append((sorted(_shape(removed)), len(idx),
                    _shape(idx.match(_toks(1, 2, 3, 4)))))
        with pytest.raises(ValueError) as e:
            idx.insert(_toks(1, 2, 3), 2)
        rec.append(str(e.value))
        return rec

    rec = _both(scenario)
    assert rec[0] == [] and rec[1][2] == 2
    assert [len(m) for m in rec[2:7]] == [2, 1, 0, 1, 1]
    assert rec[7][2] == 3 and rec[8][1] == 1


def test_radix_evictable_order_matches_the_reference():
    def scenario(side):
        idx = side.prefix.RadixPrefixIndex(page_size=1)
        a, _ = idx.insert(_toks(1, 2), 2)
        b, _ = idx.insert(_toks(1, 7), 2)
        idx.match(_toks(1, 2))               # chain a is now hotter
        first = _shape(idx.evictable())
        b[1].refs = 1
        return first, _shape(idx.evictable()), [n.last_use for n in a + b]

    first, second, _ = _both(scenario)
    # only leaves qualify, coldest first; a ref'd leaf never does
    assert [s[1] for s in first] == [_toks(7).tobytes(), _toks(2).tobytes()]
    assert [s[1] for s in second] == [_toks(2).tobytes()]


# ---------------------------------------------------------------------------
# manager
# ---------------------------------------------------------------------------


def test_donate_lookup_release_roundtrip_matches_the_reference():
    def scenario(side):
        rec = []
        pool = side.pool()
        mgr = side.prefix.PrefixCacheManager(pool, page_size=2)
        rec.append(side.donate(mgr, [1, 2, 3, 4], 2, kb=1))
        rec.append(side.donate(mgr, [1, 2, 3, 4], 2, kb=1))   # cached: no-op
        hit = mgr.lookup(_toks(1, 2, 3, 4, 9))
        rec.append((hit.n_pages, hit.tokens, mgr.live_refs,
                    sorted(hit.page_keys()[1])))
        rec.append(np.asarray(pool.get(hit.page_keys()[1]["L0.0"])).tolist())
        short = mgr.lookup(_toks(1, 2, 3, 4), max_tokens=3)
        rec.append(short.n_pages)
        mgr.release(hit)
        mgr.release(hit)                      # idempotent
        mgr.release(short)
        rec.append((mgr.live_refs, mgr.lookup(_toks(5, 5, 5, 5))))
        rec.append((mgr.snapshot(), _counts(pool)))
        mgr.close()
        mgr.close()                           # idempotent
        rec.append((len(pool.entries), _counts(pool)))
        pool.close()
        return rec

    rec = _both(scenario)
    assert rec[0] == 2 and rec[1] == 0
    assert rec[2][:3] == (2, 4, 2) and rec[4] == 1
    assert rec[3] == [1.0] * 256
    assert rec[5] == (0, None)
    assert rec[6][0]["misses"] == 1 and rec[6][0]["releases"] == 2
    assert rec[7][0] == 0


def test_refd_pages_survive_pressure_and_invalidate_once_on_release():
    """A page with live refs is never a pool victim (two readers: releasing
    one keeps it pinned); after the final release the spill below the
    ``pin_tier`` floor invalidates it exactly once."""
    def scenario(side):
        rec = []
        pool = side.pool(device_capacity=256 * 1024)
        mgr = side.prefix.PrefixCacheManager(pool, page_size=2,
                                             pin_tier="device")
        rec.append(side.donate(mgr, [1, 2], 1))
        key = next(iter(mgr.index.nodes.values())).entries["L0.0"]
        h1 = mgr.lookup(_toks(1, 2, 9))
        h2 = mgr.lookup(_toks(1, 2, 8))
        rec.append(mgr.live_refs)
        for release in (None, h1, h2):
            if release is not None:
                mgr.release(release)
            try:
                pool.put("pressure", side.page(256), "device", priority=99.0)
                rec.append("stored")
            except side.capacity_error:
                rec.append("refused")
            rec.append((pool.tier_of(key) if key in pool else None,
                        mgr.stats.invalidations, len(mgr)))
        rec.append(mgr.lookup(_toks(1, 2, 9)))      # also flushes the drop
        rec.append((key in pool, mgr.snapshot(), _counts(pool)))
        mgr.close()
        pool.close()
        return rec

    rec = _both(scenario)
    assert rec[2:6] == ["refused", ("device", 0, 1), "refused",
                        ("device", 0, 1)]
    assert rec[6] == "stored" and rec[7][1:] == (1, 0)
    assert rec[8] is None and rec[9][0] is False


def test_pin_tier_floor_invalidates_whole_chain():
    """Default floor (host): a host→remote spill of one page invalidates it
    and every deeper page of its chain; device→host spills do not."""
    def scenario(side):
        rec = []
        pool = side.pool(device_capacity=256 * 1024,
                         host_capacity=512 * 1024)
        mgr = side.prefix.PrefixCacheManager(pool, page_size=2,
                                             pin_tier="host")
        rec.append(side.donate(mgr, [1, 2, 3, 4], 2))
        k1 = mgr.index.match(_toks(1, 2))[0].entries["L0.0"]
        pool.put("p1", side.page(256), "device", priority=99.0)
        rec.append((mgr.stats.invalidations, len(mgr), pool.tier_of(k1)))
        pool.put("p2", side.page(256), "host", priority=99.0)
        rec.append((mgr.stats.invalidations, len(mgr)))
        rec.append(mgr.lookup(_toks(1, 2, 3, 4, 9)))
        rec.append((k1 in pool, [pool.occupancy(t)[0]
                                 for t in ("device", "host", "remote")]))
        rec.append((mgr.snapshot(), _counts(pool)))
        mgr.close()
        pool.close()
        return rec

    rec = _both(scenario)
    assert rec[0] == 2 and rec[1][:2] == (0, 2)
    assert rec[2] == (2, 0) and rec[3] is None
    # the cascade left the tier accounting exact: only p1 + p2 remain
    assert rec[4] == (False, [256 * 1024, 256 * 1024, 0])


def test_max_pages_budget_evicts_coldest_leaf_first():
    def scenario(side):
        rec = []
        pool = side.pool()
        mgr = side.prefix.PrefixCacheManager(pool, page_size=1, max_pages=2)
        rec.append(side.donate(mgr, [1], 1, kb=1))
        rec.append(side.donate(mgr, [2], 1, kb=1))
        mgr.release(mgr.lookup(_toks(1)))     # refresh: [2] is now coldest
        rec.append(side.donate(mgr, [3], 1, kb=1))   # evicts [2]
        rec.append((mgr.stats.evictions, len(mgr), mgr.lookup(_toks(2))))
        ha, hb = mgr.lookup(_toks(1)), mgr.lookup(_toks(3))
        rec.append(side.donate(mgr, [4], 1, kb=1))   # all ref'd: rejected
        rec.append((mgr.stats.rejected_donations, len(mgr)))
        mgr.release(ha)
        mgr.release(hb)
        rec.append((mgr.snapshot(), _counts(pool)))
        mgr.close()
        pool.close()
        return rec

    rec = _both(scenario)
    assert rec[:3] == [1, 1, 1] and rec[3] == (1, 2, None)
    assert rec[4] == 0 and rec[5] == (1, 2)


def test_manager_validation_matches_the_reference():
    def scenario(side):
        rec = []
        pool = side.pool()
        for kw in (dict(max_pages=0), dict(min_match_pages=0),
                   dict(pin_tier="nvram")):
            with pytest.raises(ValueError) as e:
                side.prefix.PrefixCacheManager(pool, page_size=2, **kw)
            rec.append(str(e.value))
        mgr = side.prefix.PrefixCacheManager(pool, page_size=2,
                                             min_match_pages=2)
        side.donate(mgr, [1, 2], 1, kb=1)
        rec.append(mgr.lookup(_toks(1, 2, 9)))  # 1 page < min_match_pages
        mgr.close()
        pool.close()
        return rec

    rec = _both(scenario)
    assert "max_pages" in rec[0] and "min_match_pages" in rec[1]
    assert "pin_tier" in rec[2] and rec[3] is None


# ---------------------------------------------------------------------------
# the scheduler with a prefix cache
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    jm = jax_build_model(JAX_REGISTRY[ARCH].reduced())
    tm = torch_build_model(TORCH_REGISTRY[ARCH].reduced())
    jp = jm.init(jax.random.key(0))
    return jm, jp, tm, params_from_numpy(jax.tree.map(np.asarray, jp), CPU)


def _family_trace(pkg, vocab, n=3, prefix_len=12, seed=1):
    """Requests sharing one prompt prefix, arriving far enough apart that
    each retires (donates) before the next arrives."""
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, vocab, size=prefix_len, dtype=np.int32)
    reqs = []
    for i in range(n):
        sfx = rng.integers(0, vocab, size=int(rng.integers(3, 8)),
                           dtype=np.int32)
        reqs.append(pkg.Request(tokens=np.concatenate([pre, sfx]),
                                max_new_tokens=4, arrival=12.0 * i, seed=i))
    return reqs


@pytest.mark.parametrize("kv_offload", [False, True])
def test_prefix_hits_are_token_identical(pair, kv_offload):
    """Hits skip the shared prompt tokens' prefill and stay token-identical
    to cold serving; under ``kv_offload`` with a 1.5-row device tier the
    cached pages ride the pool tiers and the plan's fetches."""
    jm, jp, tm, tp = pair
    row = jax_row_bytes(jm.cache_specs(1, MAX_SEQ, np.float32))
    caps = (dict(device_capacity=int(1.5 * row), host_capacity=6 * row)
            if kv_offload else {})
    runs = []
    for pkg, side, model, params in ((jsched, SIDES[0], jm, jp),
                                     (tsched, SIDES[1], tm, tp)):
        if side.jax:
            pool = jax_default_pool(transfer=JaxTransferEngine(depth=64),
                                    **caps)
        else:
            pool = torch_default_pool(device="cpu", transfer_depth=64, **caps)
        mgr = side.prefix.PrefixCacheManager(pool, page_size=4)
        sched = pkg.ContinuousScheduler(
            model, params,
            pkg.SchedulerConfig(max_batch=2, max_seq=MAX_SEQ, chunk_size=6,
                                kv_offload=kv_offload),
            pool=pool, prefix_cache=mgr)
        reqs = _family_trace(pkg, tm.cfg.vocab_size)
        out = sched.run(reqs)
        runs.append(dict(tokens=[out[r.req_id].tolist() for r in reqs],
                         stats=sched.stats.__dict__.copy(),
                         prefix=sched.prefix_stats(),
                         evictions=pool.snapshot()["evictions"]))
        sched.close()
        mgr.close()
        pool.close()
    jrun, trun = runs
    assert trun == jrun
    assert trun["stats"]["prefix_hits"] == 2     # every request after the 1st
    assert trun["stats"]["prefix_hit_tokens"] == 2 * 12
    assert trun["prefix"]["refs"] == 0               # all released at retire
    total = sum(r.prompt_len for r in _family_trace(tsched, tm.cfg.vocab_size))
    assert trun["stats"]["prefill_tokens"] == total - 2 * 12
    if kv_offload:
        assert trun["stats"]["pages_parked"] > 0
        assert trun["evictions"] > 0             # tiering pressure was real
    eng = ServeEngine(tm, tp, max_seq=MAX_SEQ)
    for r, got in zip(_family_trace(tsched, tm.cfg.vocab_size),
                      trun["tokens"]):
        want = eng.generate({"tokens": torch.from_numpy(r.tokens)[None]},
                            r.max_new_tokens)[0].tolist()
        assert got == want
