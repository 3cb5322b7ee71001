"""ModelConfig → layer-level IR graphs for training / prefill / decode.

Analytic per-layer FLOP and byte counts feed the cost model; tensor classes
mark what HyperOffload may move (activations, optimizer states, KV blocks).
Sizes and FLOPs are *per device*: pass ``shards`` to divide the global
workload across the mesh.

Simplifications (documented):
- weights are updated in place by the optimizer node (no SSA weight chain);
- per-layer saved activations are a dimension-aware aggregate
  (residual + qkv + ffn intermediates), not an op-exact list;
- decode may read only a fraction of each layer's KV (``kv_read_fraction``)
  to model sparse-attention block selection (the paper's DeepSeek+NSA
  setting, §7.3).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.core.ir import Graph


# ---------------------------------------------------------------------------
# Analytic per-layer quantities
# ---------------------------------------------------------------------------


def layer_params(cfg: ModelConfig, spec: LayerSpec, active: bool = False) -> int:
    n = cfg._mixer_params(spec) + cfg._norm_params(spec)
    if spec.ffn == "moe":
        m = cfg.moe
        experts = m.top_k if active else m.n_experts
        n += cfg.d_model * m.n_experts + experts * 3 * cfg.d_model * m.d_ff_expert
    else:
        n += cfg._ffn_params(spec)
    return n


def attn_flops(cfg: ModelConfig, spec: LayerSpec, batch: int, q_len: int,
               kv_len: int) -> float:
    """QK^T + PV flops for one layer (causal averaged when q_len == kv_len)."""
    if spec.mixer == "mamba2":
        s = cfg.ssm
        di = s.d_inner(cfg.d_model)
        # SSD: intra-chunk quadratic + state update/readout
        intra = 2.0 * batch * q_len * min(s.chunk_size, q_len) * di
        state = 4.0 * batch * q_len * di * s.d_state
        return intra + state
    window = spec.window
    eff = kv_len if window is None else min(window, kv_len)
    causal = 0.5 if (q_len == kv_len and window is None) else 1.0
    hd = cfg.head_dim if spec.mixer == "attn" else (
        cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim)
    return 4.0 * batch * q_len * eff * cfg.n_heads * hd * causal


def layer_fwd_flops(cfg: ModelConfig, spec: LayerSpec, batch: int,
                    q_len: int, kv_len: Optional[int] = None) -> float:
    kv_len = q_len if kv_len is None else kv_len
    tokens = batch * q_len
    return 2.0 * layer_params(cfg, spec, active=True) * tokens + attn_flops(
        cfg, spec, batch, q_len, kv_len)


def saved_act_bytes(cfg: ModelConfig, spec: LayerSpec, batch: int, seq: int,
                    dtype_bytes: int = 2) -> int:
    """Dimension-aware aggregate of activations saved for backward."""
    d = cfg.d_model
    if spec.mixer == "mamba2":
        inner = 2 * cfg.ssm.d_inner(d)
    elif spec.ffn == "moe":
        inner = cfg.q_dim + 2 * cfg.n_kv_heads * cfg.head_dim + 2 * cfg.moe.top_k * cfg.moe.d_ff_expert
    elif spec.mixer == "mla":
        m = cfg.mla
        inner = cfg.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim + m.v_head_dim) + 2 * cfg.d_ff
    else:
        inner = cfg.q_dim + 2 * cfg.n_kv_heads * cfg.head_dim + 2 * cfg.d_ff
    return int(batch * seq * (2 * d + inner) * dtype_bytes)


def kv_bytes_layer(cfg: ModelConfig, spec: LayerSpec, batch: int, seq: int,
                   dtype_bytes: int = 2) -> int:
    if spec.mixer == "mamba2":
        s = cfg.ssm
        di = s.d_inner(cfg.d_model)
        conv = (di + 2 * s.n_groups * s.d_state) * (s.d_conv - 1)
        state = s.n_ssm_heads(cfg.d_model) * s.headdim * s.d_state * 4
        return int(batch * (conv * dtype_bytes + state))
    eff = seq if spec.window is None else min(spec.window, seq)
    if spec.mixer == "mla":
        m = cfg.mla
        return int(batch * eff * (m.kv_lora_rank + m.qk_rope_head_dim) * dtype_bytes)
    return int(2 * batch * eff * cfg.n_kv_heads * cfg.head_dim * dtype_bytes)


# ---------------------------------------------------------------------------
# Graph builders
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TraceOptions:
    dtype_bytes: int = 2          # bf16 compute/activations/KV
    shards: int = 1               # devices sharing the global workload
    remote_opt_states: bool = True
    remote_kv: bool = True
    kv_read_fraction: float = 1.0
    grad_dtype_bytes: int = 2
    # weight precision may differ (e.g. INT4-quantized serving: 0.5)
    weight_dtype_bytes: Optional[float] = None

    @property
    def w_bytes(self) -> float:
        return self.weight_dtype_bytes if self.weight_dtype_bytes is not None \
            else float(self.dtype_bytes)


def trace_train_step(cfg: ModelConfig, batch: int, seq: int,
                     opts: TraceOptions = TraceOptions(),
                     recompute_layers: Optional[frozenset] = None) -> Graph:
    """``recompute_layers``: layer indices using activation recomputation —
    they save only the layer input (B·S·D) and pay an extra forward in the
    backward pass (the paper's baseline memory-saving technique, §7.1)."""
    g = Graph()
    sh = opts.shards
    specs = cfg.layer_specs()
    d = cfg.d_model
    hidden = int(batch * seq * d * opts.dtype_bytes / sh)
    loc_state = "remote" if opts.remote_opt_states else "device"
    recompute_layers = recompute_layers or frozenset()

    emb_bytes = int(cfg.vocab_size * d * opts.w_bytes / sh)
    g.add_tensor("w_embed", emb_bytes, "weight")
    g.add_tensor("h_embed", hidden)
    g.compute("fwd_embed", inputs=("w_embed",), outputs=("h_embed",),
              flops=2.0 * batch * seq * d / sh, hbm_bytes=emb_bytes + hidden)

    prev_h = "h_embed"
    for i, spec in enumerate(specs):
        wb = int(layer_params(cfg, spec) * opts.w_bytes / sh)
        if i in recompute_layers:
            ab = hidden  # only the layer input is saved
        else:
            ab = int(saved_act_bytes(cfg, spec, batch, seq, opts.dtype_bytes) / sh)
        g.add_tensor(f"w_{i}", wb, "weight")
        g.add_tensor(f"act_{i}", ab)
        g.add_tensor(f"h_{i}", hidden)
        g.add_tensor(f"m_{i}", int(layer_params(cfg, spec) * 4 / sh), "state", loc_state)
        g.add_tensor(f"v_{i}", int(layer_params(cfg, spec) * 4 / sh), "state", loc_state)
        fl = layer_fwd_flops(cfg, spec, batch, seq) / sh
        g.compute(f"fwd_{i}", inputs=(prev_h, f"w_{i}"),
                  outputs=(f"act_{i}", f"h_{i}"),
                  flops=fl, hbm_bytes=wb + 2 * hidden + ab)
        prev_h = f"h_{i}"

    g.add_tensor("loss_grad", hidden)
    lf = 2.0 * batch * seq * d * cfg.vocab_size / sh
    g.compute("loss", inputs=(prev_h, "w_embed"), outputs=("loss_grad",),
              flops=2 * lf, hbm_bytes=emb_bytes + 2 * hidden)

    prev_g = "loss_grad"
    for i in reversed(range(len(specs))):
        spec = specs[i]
        wb = g.tensors[f"w_{i}"].nbytes
        gb = int(layer_params(cfg, spec) * opts.grad_dtype_bytes / sh)
        g.add_tensor(f"grad_{i}", gb)
        g.add_tensor(f"gh_{i}", hidden)
        bwd_factor = 3.0 if i in recompute_layers else 2.0  # recompute pays +1 fwd
        fl = bwd_factor * layer_fwd_flops(cfg, spec, batch, seq) / sh
        g.compute(f"bwd_{i}", inputs=(prev_g, f"act_{i}", f"w_{i}"),
                  outputs=(f"grad_{i}", f"gh_{i}"),
                  flops=fl, hbm_bytes=wb + gb + 2 * hidden +
                  g.tensors[f"act_{i}"].nbytes)
        prev_g = f"gh_{i}"

    for i, spec in enumerate(specs):
        p = layer_params(cfg, spec) / sh
        g.add_tensor(f"m_new_{i}", g.tensors[f"m_{i}"].nbytes, "state")
        g.add_tensor(f"v_new_{i}", g.tensors[f"v_{i}"].nbytes, "state")
        g.compute(f"opt_{i}",
                  inputs=(f"grad_{i}", f"m_{i}", f"v_{i}", f"w_{i}"),
                  outputs=(f"m_new_{i}", f"v_new_{i}"),
                  flops=12.0 * p,
                  hbm_bytes=g.tensors[f"m_{i}"].nbytes * 4)
    return g


def trace_prefill(cfg: ModelConfig, batch: int, seq: int,
                  opts: TraceOptions = TraceOptions()) -> Graph:
    g = Graph()
    sh = opts.shards
    specs = cfg.layer_specs()
    d = cfg.d_model
    hidden = int(batch * seq * d * opts.dtype_bytes / sh)
    emb_bytes = int(cfg.vocab_size * d * opts.w_bytes / sh)
    g.add_tensor("w_embed", emb_bytes, "weight")
    g.add_tensor("h_embed", hidden)
    g.compute("embed", inputs=("w_embed",), outputs=("h_embed",),
              flops=2.0 * batch * seq * d / sh, hbm_bytes=emb_bytes + hidden)
    prev_h = "h_embed"
    for i, spec in enumerate(specs):
        wb = int(layer_params(cfg, spec) * opts.w_bytes / sh)
        kb = int(kv_bytes_layer(cfg, spec, batch, seq, opts.dtype_bytes) / sh)
        g.add_tensor(f"w_{i}", wb, "weight")
        g.add_tensor(f"h_{i}", hidden)
        g.add_tensor(f"kv_{i}", kb, "state")  # produced, then parked if remote_kv
        # sparse attention (NSA): each query attends a fraction of the keys
        eff_kv = max(1, int(seq * opts.kv_read_fraction))
        fl = layer_fwd_flops(cfg, spec, batch, seq, kv_len=eff_kv) / sh
        g.compute(f"fwd_{i}", inputs=(prev_h, f"w_{i}"),
                  outputs=(f"h_{i}", f"kv_{i}"),
                  flops=fl, hbm_bytes=wb + 2 * hidden + kb)
        prev_h = f"h_{i}"
    g.add_tensor("logits", int(batch * cfg.vocab_size * 4 / sh))
    g.compute("lm_head", inputs=(prev_h, "w_embed"), outputs=("logits",),
              flops=2.0 * batch * d * cfg.vocab_size / sh,
              hbm_bytes=emb_bytes + hidden)
    return g


def trace_decode_step(cfg: ModelConfig, batch: int, ctx_len: int,
                      opts: TraceOptions = TraceOptions()) -> Graph:
    g = Graph()
    sh = opts.shards
    specs = cfg.layer_specs()
    d = cfg.d_model
    hidden = int(batch * d * opts.dtype_bytes / sh)
    loc_kv = "remote" if opts.remote_kv else "device"
    emb_bytes = int(cfg.vocab_size * d * opts.w_bytes / sh)
    g.add_tensor("w_embed", emb_bytes, "weight")
    g.add_tensor("h_embed", hidden)
    g.compute("embed", inputs=("w_embed",), outputs=("h_embed",),
              flops=2.0 * batch * d / sh, hbm_bytes=emb_bytes // max(1, 1) + hidden)
    prev_h = "h_embed"
    for i, spec in enumerate(specs):
        wb = int(layer_params(cfg, spec) * opts.w_bytes / sh)
        kb_full = int(kv_bytes_layer(cfg, spec, batch, ctx_len, opts.dtype_bytes) / sh)
        kb_read = int(kb_full * opts.kv_read_fraction)
        g.add_tensor(f"w_{i}", wb, "weight")
        g.add_tensor(f"h_{i}", hidden)
        # resident baseline: the FULL cache lives on device; offloaded: only
        # the sparse-selected blocks are materialized (fetched from the pool)
        kv_bytes = max(kb_read, 1) if opts.remote_kv else kb_full
        g.add_tensor(f"kv_{i}", kv_bytes, "state", loc_kv)
        fl = layer_fwd_flops(cfg, spec, batch, 1, kv_len=int(ctx_len * opts.kv_read_fraction)) / sh
        g.compute(f"dec_{i}", inputs=(prev_h, f"w_{i}", f"kv_{i}"),
                  outputs=(f"h_{i}",),
                  flops=fl, hbm_bytes=wb + kb_read + 2 * hidden)
        prev_h = f"h_{i}"
    g.add_tensor("logits", int(batch * cfg.vocab_size * 4 / sh))
    g.compute("lm_head", inputs=(prev_h, "w_embed"), outputs=("logits",),
              flops=2.0 * batch * d * cfg.vocab_size / sh,
              hbm_bytes=emb_bytes + hidden)
    return g
