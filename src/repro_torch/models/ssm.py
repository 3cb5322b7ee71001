"""Mamba2 (SSD — state-space duality) mixer [arXiv:2405.21060].

The port's copy of ``repro.models.ssm``. The full-sequence path uses the
chunked SSD algorithm (intra-chunk quadratic blocks plus the inter-chunk
state recurrence); decode is the O(1) per-token recurrence. Forward and
prefill share one helper that runs the scan through ``ops.ssd_scan`` on a
CUDA tensor (the Hopper kernel, which also returns the final state) and
through :func:`ssd_chunked` on the CPU or under
``use_attention_impl("plain")``. Prefill and decode write the layer's
``conv`` and ``ssm`` cache slices in place, where the reference returns a
new cache.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import runtime
from repro_torch.models.common import dense_init, rmsnorm

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Params & cache
# ---------------------------------------------------------------------------


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    nh = s.n_ssm_heads(cfg.d_model)
    conv_dim = di + 2 * s.n_groups * s.d_state
    return s, di, nh, conv_dim


def init_mamba_params(cfg: ModelConfig, dtype: torch.dtype,
                      device: torch.device, generator: torch.Generator,
                      stack: Sequence[int] = ()) -> Dict[str, torch.Tensor]:
    """Random parameters; ``A_log``, ``D``, ``dt_bias`` and ``gate_norm``
    stay fp32 whatever ``dtype`` is, as in the reference."""
    s, di, nh, conv_dim = _dims(cfg)
    d = cfg.d_model
    in_dim = 2 * di + 2 * s.n_groups * s.d_state + nh
    st, ax = tuple(stack), len(stack)
    f32 = dict(dtype=torch.float32, device=device)
    # dt bias such that softplus(dt_bias) spans ~[1e-3, 1e-1] (mamba default)
    u = torch.rand(st + (nh,), generator=generator, **f32)
    dt_init = torch.exp(u * (math.log(0.1) - math.log(0.001))
                        + math.log(0.001))
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))   # inverse softplus
    a_init = torch.log(1.0 + 15.0 * torch.rand(st + (nh,), generator=generator,
                                               **f32))
    conv_w = torch.randn(st + (s.d_conv, conv_dim), generator=generator, **f32)
    return {
        "in_proj": dense_init(st + (d, in_dim), dtype, device, generator, ax),
        "conv_w": (0.1 * conv_w).to(dtype),
        "conv_b": torch.zeros(st + (conv_dim,), dtype=dtype, device=device),
        "A_log": a_init,
        "D": torch.ones(st + (nh,), **f32),
        "dt_bias": dt_bias,
        "gate_norm": torch.zeros(st + (di,), **f32),
        "out_proj": dense_init(st + (di, d), dtype, device, generator, ax),
    }


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device: torch.device,
                     stack: Sequence[int] = ()) -> Dict[str, torch.Tensor]:
    """The conv window in ``dtype``; the SSM state always in fp32."""
    s, di, nh, conv_dim = _dims(cfg)
    st = tuple(stack)
    return {
        "conv": torch.zeros(st + (batch, conv_dim, s.d_conv - 1), dtype=dtype,
                            device=device),
        "ssm": torch.zeros(st + (batch, nh, s.headdim, s.d_state),
                           dtype=torch.float32, device=device),
    }


# ---------------------------------------------------------------------------
# Chunked SSD (full sequence)
# ---------------------------------------------------------------------------


def segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., L) -> (..., L, L); out[i, j] = sum_{k=j+1..i} a_k for i>=j,
    else NEG_INF (whose exp is 0)."""
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    ln = a.shape[-1]
    idx = torch.arange(ln, device=a.device)
    mask = idx[:, None] >= idx[None, :]
    return torch.where(mask, diff, NEG_INF)


def ssd_chunked(
    x: torch.Tensor,       # (B, S, H, P)   already scaled by dt
    a: torch.Tensor,       # (B, S, H)      = dt * A   (negative)
    b_mat: torch.Tensor,   # (B, S, H, N)
    c_mat: torch.Tensor,   # (B, S, H, N)
    chunk: int,
    init_state: Optional[torch.Tensor] = None,   # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan. Returns (y (B,S,H,P), final_state (B,H,P,N)),
    both fp32."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    assert s % chunk == 0, (s, chunk)
    nc = s // chunk
    xc = x.reshape(bsz, nc, chunk, h, p).float()
    bc = b_mat.reshape(bsz, nc, chunk, h, n).float()
    cc = c_mat.reshape(bsz, nc, chunk, h, n).float()
    ac = a.reshape(bsz, nc, chunk, h).permute(0, 3, 1, 2).float()  # (B,H,C,L)
    a_cumsum = torch.cumsum(ac, dim=-1)                            # (B,H,C,L)

    # 1) intra-chunk (diagonal blocks)
    l_mat = torch.exp(segsum(ac))                                  # (B,H,C,L,L)
    y_diag = torch.einsum("bclhn,bcshn,bhcls,bcshp->bclhp", cc, bc, l_mat, xc)

    # 2) per-chunk final states
    decay_states = torch.exp(a_cumsum[..., -1:] - a_cumsum)        # (B,H,C,L)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", bc, decay_states, xc)

    # 3) inter-chunk recurrence
    if init_state is None:
        init_state = torch.zeros((bsz, h, p, n), dtype=torch.float32,
                                 device=x.device)
    states = torch.cat([init_state[:, None].float(), states], dim=1)
    chunk_sums = F.pad(a_cumsum[..., -1], (1, 0))                  # (B,H,C+1)
    decay_chunk = torch.exp(segsum(chunk_sums))                    # (B,H,C+1,C+1)
    new_states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)
    prev_states, final_state = new_states[:, :-1], new_states[:, -1]

    # 4) state -> output
    state_decay_out = torch.exp(a_cumsum)                          # (B,H,C,L)
    y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", cc, prev_states,
                         state_decay_out)

    y = (y_diag + y_off).reshape(bsz, s, h, p)
    return y, final_state


# ---------------------------------------------------------------------------
# Causal depthwise conv
# ---------------------------------------------------------------------------


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """x: (B, S, C); w: (K, C) depthwise causal conv via shifted adds."""
    k, slen = w.shape[0], x.shape[1]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        shift = k - 1 - i
        xi = F.pad(x, (0, 0, shift, 0))[:, :slen]
        out = out + xi.float() * w[i].float()
    return (out + b.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Block forward
# ---------------------------------------------------------------------------


def _project(cfg: ModelConfig, p: Dict, x: torch.Tensor):
    s, di, nh, conv_dim = _dims(cfg)
    zxbcdt = x @ p["in_proj"]
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + conv_dim]
    dt_raw = zxbcdt[..., di + conv_dim:]
    return z, xbc, dt_raw


def _split_xbc(cfg: ModelConfig, xbc: torch.Tensor):
    """x, B, C from the conv output; B and C broadcast from groups to heads
    (each group to ``nh // g`` heads in a row, as ``jnp.repeat``). With one
    group that is a view with head stride 0, which the kernel reads in
    place; with more it is a copy."""
    s, di, nh, conv_dim = _dims(cfg)
    g, n = s.n_groups, s.d_state
    xs = xbc[..., :di]
    shape = xbc.shape[:-1]

    def to_heads(m):
        return m.reshape(*shape, g, 1, n).expand(
            *shape, g, nh // g, n).reshape(*shape, nh, n)

    return (xs, to_heads(xbc[..., di:di + g * n]),
            to_heads(xbc[..., di + g * n:]))


def _ssd_scan(x_dt, a_dt, b_mat, c_mat, chunk):
    """The scan, through the kernel on a CUDA tensor (``"kernel"``) and
    :func:`ssd_chunked` otherwise."""
    if runtime.attention_impl(x_dt.device) == "kernel":
        from repro_torch.kernels import ops as kops
        return kops.ssd_scan(x_dt, a_dt, b_mat, c_mat, chunk)
    return ssd_chunked(x_dt, a_dt, b_mat, c_mat, chunk)


def _mixer(cfg: ModelConfig, p: Dict, x: torch.Tensor):
    """The full-sequence block shared by forward and prefill. Returns
    (out (B,S,D), the conv's pre-activation input xbc, final SSM state)."""
    s_cfg, di, nh, conv_dim = _dims(cfg)
    bsz, slen, _ = x.shape
    z, xbc, dt_raw = _project(cfg, p, x)
    xbc_act = F.silu(causal_conv(xbc, p["conv_w"], p["conv_b"]))
    xs, b_mat, c_mat = _split_xbc(cfg, xbc_act)
    xs = xs.reshape(bsz, slen, nh, s_cfg.headdim)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])                 # (B,S,H)
    a = -torch.exp(p["A_log"])                                     # (H,)
    x_dt = xs.float() * dt[..., None]
    a_dt = dt * a[None, None, :]
    # pad the sequence to a chunk multiple: zero a is no decay and zero x no
    # input, so the final state is unchanged
    chunk = min(s_cfg.chunk_size, slen)
    pad = (-slen) % chunk
    if pad:
        x_dt = F.pad(x_dt, (0, 0, 0, 0, 0, pad))
        a_dt = F.pad(a_dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, 0, 0, pad))
    y, final_state = _ssd_scan(x_dt, a_dt, b_mat, c_mat, chunk)
    y = y[:, :slen]
    y = y + p["D"][None, None, :, None] * xs.float()
    y = y.reshape(bsz, slen, di)
    y = y * F.silu(z.float())
    y = rmsnorm(y.to(x.dtype), p["gate_norm"], cfg.norm_eps)
    return y @ p["out_proj"], xbc, final_state


def mamba_forward(cfg: ModelConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence Mamba2 block. x: (B, S, D) -> (B, S, D)."""
    return _mixer(cfg, p, x)[0]


def mamba_prefill(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                  cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence forward that also fills the recurrent cache in place:
    the last (d_conv - 1) pre-activation conv inputs and the final state."""
    out, xbc, final_state = _mixer(cfg, p, x)
    k, slen = cfg.ssm.d_conv - 1, x.shape[1]
    tail = xbc[:, -k:, :] if slen >= k else F.pad(xbc, (0, 0, k - slen, 0))
    cache["conv"].copy_(tail.transpose(1, 2))
    cache["ssm"].copy_(final_state)
    return out, cache


def mamba_decode(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                 cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """Single-token recurrent step, x: (B, 1, D); the cache is updated in
    place."""
    s_cfg, di, nh, conv_dim = _dims(cfg)
    bsz = x.shape[0]
    z, xbc, dt_raw = _project(cfg, p, x)           # (B,1,·)
    z, xbc, dt_raw = z[:, 0], xbc[:, 0], dt_raw[:, 0]
    # conv over the stored window + current token
    window = torch.cat([cache["conv"],
                        xbc[:, :, None].to(cache["conv"].dtype)], dim=2)
    w = p["conv_w"].float()                        # (K, C)
    conv_out = (window.float() * w.T[None]).sum(dim=-1) + p["conv_b"].float()
    xbc_act = F.silu(conv_out).to(x.dtype)         # (B, C)
    xs, b_mat, c_mat = _split_xbc(cfg, xbc_act)
    xs = xs.reshape(bsz, nh, s_cfg.headdim)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])  # (B,H)
    a = -torch.exp(p["A_log"])
    da = torch.exp(dt * a[None, :])                 # (B,H)
    state = cache["ssm"] * da[..., None, None]
    state = state + torch.einsum("bh,bhn,bhp->bhpn", dt, b_mat.float(),
                                 xs.float())
    y = torch.einsum("bhn,bhpn->bhp", c_mat.float(), state)
    y = y + p["D"][None, :, None] * xs.float()
    y = y.reshape(bsz, di)
    y = y * F.silu(z.float())
    y = rmsnorm(y.to(x.dtype), p["gate_norm"], cfg.norm_eps)
    out = (y @ p["out_proj"])[:, None, :]
    cache["conv"].copy_(window[..., 1:])
    cache["ssm"].copy_(state)
    return out, cache
