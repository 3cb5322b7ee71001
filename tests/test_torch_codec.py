"""The port's KV page codecs (``repro_torch.pool.codec``) and the codec
tiers of its pool against the JAX package's, on the CPU.

The same seeded numpy pages go through both: int8 and fp8 payloads must be
bitwise equal and the per-page scales equal; the round trip stays within
``roundtrip_bound``; under the same put/spill/get sequence every pool
counter, tier occupancy and per tier-pair transfer count and byte total is
the reference's (measured times excepted). ``PagedKVCache.attend_fused``
over int8 pages equals the gather path bitwise and the reference's result
within fp32 rounding."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.offload.kvcache import PagedKVCache as JaxPagedKVCache
from repro.pool import TierSpec as JaxTierSpec
from repro.pool import TierTopology as JaxTierTopology
from repro.pool import default_pool as jax_default_pool
from repro.pool import make_codec as jax_make_codec
from repro.pool import roundtrip_bound as jax_roundtrip_bound
from repro_torch.offload.kvcache import PagedKVCache
from repro_torch.pool import (
    CODECS, EncodedPage, TierSpec, TierTopology, default_pool, make_codec,
    roundtrip_bound, supports_fp8,
)
from repro_torch.pool import backend as B

DTYPES = {"float32": (np.float32, torch.float32, jnp.float32),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16, jnp.bfloat16)}


def _pages(seed, shape=(2, 8, 2, 16), dtype="float32"):
    """One seeded page for each side (bf16: the numpy fp32 draw rounded to
    bf16 once, then handed to both as the same bits)."""
    x = (np.random.default_rng(seed).standard_normal(shape) * (seed + 1))
    np_dt, t_dt, j_dt = DTYPES[dtype]
    x = x.astype(np.float32).astype(np_dt)
    t = torch.from_numpy(x.astype(np.float32)).to(t_dt)
    return jnp.asarray(x, j_dt), t


def _bits(a):
    """Raw bytes of a payload (either framework)."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy().tobytes()
    return np.asarray(a).tobytes()


def _counts(snap):
    """A pool snapshot without measured times and backend names."""
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


# ---------------------------------------------------------------------------
# the codecs themselves
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", ["int8", "fp8"])
def test_payload_and_scale_match_the_reference_bitwise(name, dtype, seed):
    xj, xt = _pages(seed, dtype=dtype)
    jp, js = jax_make_codec(name).encode(xj)
    tp, ts = make_codec(name).encode(xt)
    assert tp.dtype == (torch.int8 if name == "int8"
                        else torch.float8_e4m3fn)
    assert _bits(tp) == _bits(jp)
    assert ts.dim() == 0 and ts.dtype == torch.float32
    assert float(ts) == js
    # decoding gives the reference's values bit for bit as well
    yj = make_codec(name).decode(tp, ts, xt.dtype)
    yr = jax_make_codec(name).decode(jp, js, dtype)
    assert yj.dtype == xt.dtype
    np.testing.assert_array_equal(yj.float().numpy(),
                                  np.asarray(yr, np.float32))


def test_fp8_payload_at_the_format_edge():
    """Pages whose elements land exactly on ±448 after scaling (the absmax
    element and its copies), and next to it, give the reference's bytes."""
    rng = np.random.default_rng(5)
    for absmax in (1.0, 3.0, 0.1, 448.0, 7e-3):
        x = rng.uniform(-absmax, absmax, (4, 64)).astype(np.float32)
        x[0, :4] = (absmax, -absmax, absmax, np.nextafter(
            np.float32(absmax), np.float32(0)))
        x[1, 0] = absmax * (447.5 / 448)
        jp, js = jax_make_codec("fp8").encode(jnp.asarray(x))
        tp, ts = make_codec("fp8").encode(torch.from_numpy(x))
        assert float(ts) == js
        assert _bits(tp) == _bits(jp)
        assert tp[0, :3].float().abs().eq(448.0).all()


def test_all_zero_page_has_unit_scale():
    for name in ("int8", "fp8"):
        q, s = make_codec(name).encode(torch.zeros(3, 5))
        assert float(s) == 1.0 and not q.float().any()
        assert float(jax_make_codec(name).encode(jnp.zeros((3, 5)))[1]) == 1.0


@pytest.mark.parametrize("name", ["int8", "fp8"])
def test_codec_roundtrip_within_hard_bound(name):
    c = make_codec(name)
    _, x = _pages(1)
    payload, scale = c.encode(x)
    y = c.decode(payload, scale, x.dtype)
    assert y.shape == x.shape and y.dtype == x.dtype
    err = float((y - x).abs().max())
    absmax = float(x.abs().max())
    bound = roundtrip_bound(c, absmax)
    assert bound == jax_roundtrip_bound(jax_make_codec(name), absmax)
    assert err <= bound, (name, err, bound)
    # 4-byte elements become 1-byte payloads (+4 B of scale)
    assert c.encoded_nbytes(x.shape, x.dtype) == x.numel() + 4
    assert c.ratio(4) == 0.25 and c.ratio(2) == 0.5


def test_codec_none_and_unknown():
    assert CODECS == ("none", "int8", "fp8")
    assert make_codec(None) is None and make_codec("none") is None
    with pytest.raises(ValueError, match="unknown") as te:
        make_codec("zstd")
    with pytest.raises(ValueError) as je:
        jax_make_codec("zstd")
    assert str(te.value) == str(je.value)
    assert supports_fp8()


# ---------------------------------------------------------------------------
# codec tiers of the pool
# ---------------------------------------------------------------------------


def _both(fn):
    """Run ``fn(make_pool, page, fetch)`` on each package; returns the two
    results (JAX first)."""
    out = []
    for make, page, fetch in (
            (jax_default_pool, lambda s, shp: _pages(s, shp)[0], np.asarray),
            (lambda **kw: default_pool(device="cpu", **kw),
             lambda s, shp: _pages(s, shp)[1], lambda t: t.numpy())):
        out.append(fn(make, page, fetch))
    return out


def test_codec_pool_records_wire_bytes_not_decoded():
    """Tier occupancy, bytes stored and fetched and the per tier-pair table
    all see encoded bytes, in both packages alike."""
    def drive(make, page, fetch):
        p = make(topology=(JaxTierTopology if make is jax_default_pool
                           else TierTopology).default(),
                 codec="int8", codec_below="host")
        x = page(2, (2, 8, 2, 16))                    # 4 KiB decoded
        e = p.put("pg", x, tier="host")
        assert e.nbytes == 2 * 8 * 2 * 16 + 4
        y = fetch(p.get("pg"))
        assert y.shape == tuple(x.shape)
        assert np.abs(y - fetch(x)).max() < 0.05
        snap = _counts(p.snapshot())
        p.close()
        return snap, y

    (js, jy), (ts, ty) = _both(drive)
    assert ts == js
    assert ts["tier/host"]["used"] == ts["bytes_stored"] == 516
    assert ts["transfer"]["pairs"] == {"device->host": (1, 516),
                                       "host->device": (1, 516)}
    np.testing.assert_array_equal(ty, jy)


def test_codec_spill_encodes_at_boundary_and_moves_payload_below():
    """A device→host spill quantizes (wire bytes shrink 4×); host→remote
    moves the payload as it is, so the two-hop decode equals the one-hop
    decode byte for byte. Counters equal the reference's."""
    wire = 16 * 16 + 4

    def drive(make, page, fetch):
        topo = (JaxTierTopology if make is jax_default_pool
                else TierTopology).default(device_capacity=1500,
                                           host_capacity=300)
        p = make(topology=topo, codec="int8", codec_below="host")
        x = page(3, (16, 16))                         # 1024 B decoded
        p.put("p0", x, tier="device")
        assert p.entries["p0"].nbytes == 1024
        p.put("p1", x, tier="device")                 # spills p0 → host
        assert p.tier_of("p0") == "host" and p.entries["p0"].nbytes == wire
        one_hop = fetch(p.get("p0"))
        p.put("p2", x, tier="device")                 # p1→host, p0→remote
        assert p.tier_of("p0") == "remote" and p.entries["p0"].nbytes == wire
        np.testing.assert_array_equal(fetch(p.get("p0")), one_hop)
        snap = _counts(p.snapshot())
        p.close()
        return snap, one_hop

    (js, jy), (ts, ty) = _both(drive)
    assert ts == js
    assert ts["transfer"]["pairs"]["host->remote"] == (1, wire)
    np.testing.assert_array_equal(ty, jy)


def test_codec_raises_admission_capacity():
    """Reservations stay in decoded bytes, but a codec tier counts at its
    decoded-equivalent capacity (4× the raw budget for fp32 pages under
    int8); occupancy is scaled per tier too. Same answers as the
    reference's ledger."""
    def drive(make, page, fetch):
        topo = (JaxTierTopology if make is jax_default_pool
                else TierTopology).default(device_capacity=0,
                                           host_capacity=1100,
                                           remote_capacity=0)
        p = make(topology=topo, codec="int8", codec_below="host")
        out = [p.reserve("raw", 4000, ("host",)),
               p.reserve("scaled", 4000, ("host",), itemsize=4),
               p.headroom(("host",), itemsize=4),
               p.tier_scale("host", 4), p.tier_scale("host", 2),
               p.tier_scale("host", None), p.tier_scale("device", 4)]
        p.release("scaled")
        p.put("pg", page(4, (16, 16)), tier="host")   # 260 B at rest
        out.append(p.headroom(("host",), itemsize=4))
        p.close()
        return out

    jout, tout = _both(drive)
    assert tout == jout
    assert tout == [False, True, 4 * 1100 - 4000, 0.25, 0.5, 1.0, 1.0,
                    4 * (1100 - 260)]


def test_codec_boundary_validation():
    for kw in (dict(codec="int8", codec_below="device"),
               dict(codec="int8", codec_below="nvme")):
        with pytest.raises(ValueError) as je:
            jax_default_pool(**kw)
        with pytest.raises(ValueError) as te:
            default_pool(device="cpu", **kw)
        assert str(te.value) == str(je.value)
    p = default_pool(device="cpu", codec="none")
    assert not any(isinstance(st.backend, B.CodecBackend)
                   for st in p.tiers.values())
    p.close()
    p = default_pool(device="cpu", codec="fp8")      # boundary: store tier
    assert [type(p.tiers[n].backend).__name__ for n in p.spill_order] == \
        ["DeviceBackend", "CodecBackend", "CodecBackend"]
    assert p.tiers["remote"].backend.name == "fp8[modeled[remote]]"
    p.close()


def test_codec_encoded_pages_survive_n_tier_chain():
    """Every tier below the boundary is wrapped, so a page spilling to the
    bottom of a deep chain stays decodable; the port and the reference
    place and decode it alike."""
    def drive(make, page, fetch):
        spec = JaxTierSpec if make is jax_default_pool else TierSpec
        topo_t = JaxTierTopology if make is jax_default_pool else TierTopology
        topo = topo_t(tiers=(spec("l0", kind="numpy", capacity=300,
                                  admit=True),
                             spec("l1", kind="numpy", capacity=300),
                             spec("l2", kind="numpy")))
        p = make(topology=topo, codec="fp8", codec_below="l0")
        x = page(5, (16, 16))
        for i in range(3):
            p.put(f"k{i}", x, tier="l0")              # 260 B each encoded
        tiers = [p.tier_of(f"k{i}") for i in range(3)]
        y = fetch(p.get("k0"))
        absmax = float(np.abs(fetch(x)).max())       # fp8, single hop
        assert np.abs(y - fetch(x)).max() <= roundtrip_bound(
            make_codec("fp8"), absmax)
        snap = _counts(p.snapshot())
        p.close()
        return tiers, y, snap

    (jt, jy, js), (tt, ty, ts) = _both(drive)
    assert tt == jt == ["l2", "l1", "l0"]
    np.testing.assert_array_equal(ty, jy)
    assert ts == js


def test_codec_handle_reuses_its_payload_buffer():
    """A re-put of a key in the same codec tier encodes into the previous
    handle's payload buffer (on the card that buffer is pinned: pinning a
    fresh one per put would cost more than the copy)."""
    p = default_pool(device="cpu", codec="int8", codec_below="host")
    _, x = _pages(6)
    p.put("k", x, tier="host")
    h = p.entries["k"].handle
    assert isinstance(h, EncodedPage) and p.is_host_resident("k")
    payload = h.payload
    p.put("k", x * 2, tier="host")
    h2 = p.entries["k"].handle
    assert h2.payload is payload and h2 is not h
    np.testing.assert_allclose(p.get("k").numpy(), (x * 2).numpy(),
                               atol=roundtrip_bound(
                                   make_codec("int8"),
                                   float((x * 2).abs().max())))
    p.close()


# ---------------------------------------------------------------------------
# fused paged decode over int8 pages
# ---------------------------------------------------------------------------


def _filled(pkg_cache, make_pool, codec, xs):
    pool = make_pool(codec=codec, codec_below="host")
    cache = pkg_cache.create(batch=2, max_seq=64, page_size=8, n_kv_heads=2,
                             head_dim=32, pool=pool)
    k, v, _ = xs
    cache.prefill(k, v)
    return cache, pool


@pytest.mark.parametrize("codec", [None, "int8"])
def test_attend_fused_codec_matches_gather_and_the_reference(codec):
    """Under an int8 pool codec both paths decode the same quantized pages:
    fused equals gather bitwise (the CPU runs the kernel's plain version),
    stays within 0.05 of the full-precision run, and equals the JAX
    cache's result within 1e-5 (fp32 softmax rounding of two frameworks).
    """
    rng = np.random.default_rng(2)
    b, s0, hkv, hq, d = 2, 29, 2, 4, 32
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s0, hkv, d), (b, s0, hkv, d), (b, hq, d))]
    tx = [torch.from_numpy(a) for a in arrs]
    jx = [jnp.asarray(a) for a in arrs]
    scale = d ** -0.5
    cache, pool = _filled(PagedKVCache, lambda **kw: default_pool(
        device="cpu", **kw), codec, tx)
    jcache, jpool = _filled(JaxPagedKVCache, jax_default_pool, codec, jx)
    exact, epool = _filled(PagedKVCache, lambda **kw: default_pool(
        device="cpu", **kw), None, tx)
    q = tx[2]
    gather = cache.attend(q, scale=scale)
    fused = cache.attend_fused(q, scale=scale)
    assert torch.equal(fused, gather)
    oracle = exact.attend(q, scale=scale)
    assert float((fused - oracle).abs().max()) < 0.05
    jgather = jcache.attend(jx[2], scale=scale)
    ref = jcache.attend_fused(jx[2], scale=scale)
    np.testing.assert_allclose(gather.numpy(), np.asarray(jgather), atol=1e-5)
    np.testing.assert_allclose(fused.numpy(), np.asarray(ref), atol=1e-5)
    assert _counts(pool.snapshot()) == _counts(jpool.snapshot())
    if codec:
        assert pool.snapshot()["tier/host"]["used"] == \
            2 * 3 * (b * 8 * hkv * d + 4)
    for p in (pool, jpool, epool):
        p.close()
