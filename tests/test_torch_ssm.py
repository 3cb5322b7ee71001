"""The PyTorch port's Mamba2 mixer against the JAX package's.

``mamba2-370m`` ``.reduced()``: the JAX block's parameters are carried
across with ``params_from_numpy`` (``dtype=None``, so ``A_log``, ``D``,
``dt_bias`` and ``gate_norm`` stay fp32 as the reference keeps them),
inputs come from numpy with a seed, and both sides run fp32. Tolerance:
1e-4 against JAX (the two frameworks order their sums differently), and the
chunked scan against the O(S) recurrence as in ``tests/test_ssm.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as JAX_REGISTRY
from repro.models import ssm as jssm
from repro_torch.configs import REGISTRY as TORCH_REGISTRY
from repro_torch.convert import params_from_numpy
from repro_torch.models import ssm as tssm

ATOL = 1e-4
CPU = torch.device("cpu")
ARCH = "mamba2-370m"


def recurrent_reference(x, a, b_mat, c_mat):
    """Literal per-token SSM recurrence."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    state = torch.zeros((bsz, h, p, n))
    ys = []
    for t in range(s):
        da = torch.exp(a[:, t])                                   # (B,H)
        state = state * da[..., None, None] + torch.einsum(
            "bhn,bhp->bhpn", b_mat[:, t], x[:, t])
        ys.append(torch.einsum("bhn,bhpn->bhp", c_mat[:, t], state))
    return torch.stack(ys, dim=1), state


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_ssd_chunked_matches_recurrence(chunk):
    rng = np.random.default_rng(0)
    bsz, s, h, p, n = 2, 64, 2, 8, 4
    x = torch.from_numpy(rng.standard_normal((bsz, s, h, p), np.float32))
    a = -torch.from_numpy(rng.standard_normal((bsz, s, h), np.float32)).abs() \
        * 0.2
    bm = torch.from_numpy(rng.standard_normal((bsz, s, h, n), np.float32)) * 0.5
    cm = torch.from_numpy(rng.standard_normal((bsz, s, h, n), np.float32)) * 0.5
    y_c, st_c = tssm.ssd_chunked(x, a, bm, cm, chunk)
    y_r, st_r = recurrent_reference(x, a, bm, cm)
    torch.testing.assert_close(y_c, y_r, atol=1e-4, rtol=0)
    torch.testing.assert_close(st_c, st_r, atol=1e-4, rtol=0)


def _pair(seed=0):
    jcfg, tcfg = JAX_REGISTRY[ARCH].reduced(), TORCH_REGISTRY[ARCH].reduced()
    jp = jssm.init_mamba_params(jcfg, jax.random.key(seed), jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), CPU)
    assert tp["A_log"].dtype == tp["gate_norm"].dtype == torch.float32
    return jcfg, jp, tcfg, tp


def _x(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return (0.5 * rng.standard_normal((b, s, cfg.d_model))).astype(np.float32)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("slen", [20, 64, 150])   # ragged, one chunk, three
def test_mamba_forward_matches_jax(slen):
    jcfg, jp, tcfg, tp = _pair()
    x = _x(tcfg, 2, slen, seed=1)
    out = tssm.mamba_forward(tcfg, tp, torch.from_numpy(x))
    assert out.shape == (2, slen, tcfg.d_model)
    _close(out, jssm.mamba_forward(jcfg, jp, jnp.asarray(x)))


def test_mamba_prefill_and_decode_match_jax_and_write_the_cache_in_place():
    jcfg, jp, tcfg, tp = _pair()
    b, s = 2, 37
    x = _x(tcfg, b, s + 2, seed=2)
    jcache = jssm.init_mamba_cache(jcfg, b, jnp.float32)
    tcache = tssm.init_mamba_cache(tcfg, b, torch.float32, CPU)
    assert tcache["ssm"].dtype == torch.float32
    conv, ssm_state = tcache["conv"], tcache["ssm"]
    jo, jcache = jssm.mamba_prefill(jcfg, jp, jnp.asarray(x[:, :s]), jcache)
    to, tcache = tssm.mamba_prefill(tcfg, tp, torch.from_numpy(x[:, :s]),
                                    tcache)
    _close(to, jo)
    for key in ("conv", "ssm"):
        assert tuple(tcache[key].shape) == jcache[key].shape
        _close(tcache[key], jcache[key])
    for t in (s, s + 1):
        jo, jcache = jssm.mamba_decode(jcfg, jp, jnp.asarray(x[:, t:t + 1]),
                                       jcache)
        to, tcache = tssm.mamba_decode(tcfg, tp,
                                       torch.from_numpy(x[:, t:t + 1]), tcache)
        assert to.shape == (b, 1, tcfg.d_model)
        _close(to, jo)
        _close(tcache["conv"], jcache["conv"])
        _close(tcache["ssm"], jcache["ssm"])
    # the reference returns a new cache; the port writes the same tensors
    assert tcache["conv"] is conv and tcache["ssm"] is ssm_state


def test_mamba_prefill_shorter_than_the_conv_window_matches_jax():
    jcfg, jp, tcfg, tp = _pair(seed=3)
    x = _x(tcfg, 2, 2, seed=4)                 # 2 tokens < d_conv - 1 = 3
    jcache = jssm.init_mamba_cache(jcfg, 2, jnp.float32)
    tcache = tssm.init_mamba_cache(tcfg, 2, torch.float32, CPU)
    jo, jcache = jssm.mamba_prefill(jcfg, jp, jnp.asarray(x), jcache)
    to, tcache = tssm.mamba_prefill(tcfg, tp, torch.from_numpy(x), tcache)
    _close(to, jo)
    _close(tcache["conv"], jcache["conv"])
    _close(tcache["ssm"], jcache["ssm"])


def test_mamba_prefill_then_decode_matches_forward():
    """prefill(s-1) + decode(1) equals the full-sequence block output."""
    _, _, cfg, p = _pair()
    bsz, s = 2, 20
    x = torch.from_numpy(_x(cfg, bsz, s, seed=5))
    full = tssm.mamba_forward(cfg, p, x)
    cache = tssm.init_mamba_cache(cfg, bsz, torch.float32, CPU)
    out_pre, cache = tssm.mamba_prefill(cfg, p, x[:, :s - 1], cache)
    torch.testing.assert_close(out_pre, full[:, :s - 1], atol=2e-4, rtol=0)
    out_dec, cache = tssm.mamba_decode(cfg, p, x[:, s - 1:s], cache)
    torch.testing.assert_close(out_dec[:, 0], full[:, s - 1], atol=2e-4,
                               rtol=0)


def test_mamba_decode_chain_long():
    """Many sequential decode steps track the full-sequence output."""
    _, _, cfg, p = _pair()
    bsz, s = 1, 33
    x = torch.from_numpy(_x(cfg, bsz, s, seed=6))
    full = tssm.mamba_forward(cfg, p, x)
    cache = tssm.init_mamba_cache(cfg, bsz, torch.float32, CPU)
    outs = []
    for t in range(s):
        o, cache = tssm.mamba_decode(cfg, p, x[:, t:t + 1], cache)
        outs.append(o[:, 0])
    torch.testing.assert_close(torch.stack(outs, dim=1), full, atol=3e-4,
                               rtol=0)


def test_split_xbc_broadcasts_one_group_without_a_copy():
    """With one group the port hands B and C to the scan as head-stride-0
    views, where the reference materialises ``jnp.repeat``."""
    jcfg, _, cfg, _ = _pair()
    s, di, nh, conv_dim = tssm._dims(cfg)
    xbc = torch.randn(2, 5, conv_dim, generator=torch.Generator().manual_seed(0))
    xs, bm, cm = tssm._split_xbc(cfg, xbc)
    assert bm.shape == cm.shape == (2, 5, nh, s.d_state)
    assert bm.stride(2) == cm.stride(2) == 0
    assert bm.data_ptr() == xbc[..., di:].data_ptr()
    _, jb, jc = jssm._split_xbc(jcfg, jnp.asarray(xbc.numpy()))
    np.testing.assert_array_equal(bm.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(cm.numpy(), np.asarray(jc))
