"""Configuration system for model architectures and workload shapes.

The PyTorch port's own copy of ``repro.configs.base``: the same dataclasses
and the same ``reduced()`` logic, so a config built here describes exactly
the model the JAX reference builds from the same name. Every architecture
is a ``ModelConfig`` made of repeated layer *segments* — ``(pattern,
repeats)`` pairs — whose parameters are stacked along a leading ``repeats``
dimension (the layout the reference scans over and the port loops over).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2/MiniCPM3 style)."""

    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    d_ff_expert: int = 0          # per-expert hidden size
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block configuration [arXiv:2405.21060]."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64
    n_groups: int = 1
    chunk_size: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_ssm_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.headdim


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec models (whisper). Frontend is a stub:
    ``input_specs`` supplies precomputed frame embeddings."""

    n_layers: int = 24
    n_frames: int = 1500


# ---------------------------------------------------------------------------
# Layer specs & segments
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LayerSpec:
    """One decoder layer = mixer + ffn, pre-norm residual structure.

    mixer: "attn" | "mla" | "mamba2"
    ffn:   "swiglu" | "gelu" | "moe" | "none"
    window: sliding-window size for this layer's attention (None = full)
    cross_attn: whisper decoder layers attend to encoder output
    """

    mixer: str = "attn"
    ffn: str = "swiglu"
    window: Optional[int] = None
    cross_attn: bool = False
    post_norms: bool = False      # gemma2-style post-sublayer RMSNorm


@dataclass(frozen=True)
class Segment:
    pattern: Tuple[LayerSpec, ...]
    repeats: int

    @property
    def n_layers(self) -> int:
        return len(self.pattern) * self.repeats


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | ssm | moe | hybrid | audio | vlm
    citation: str

    d_model: int = 512
    n_heads: int = 8
    n_kv_heads: int = 8
    head_dim: int = 64
    d_ff: int = 2048
    vocab_size: int = 32000

    segments: Tuple[Segment, ...] = ()

    # normalization / activation
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    norm_eps: float = 1e-6

    # position encoding
    rope_mode: str = "rope"       # rope | mrope | learned | none
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)

    # logits
    tie_embeddings: bool = True
    scale_embeddings: bool = False   # multiply token embeddings by sqrt(d_model)
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    query_scale: Optional[float] = None   # override 1/sqrt(head_dim)

    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder: Optional[EncoderConfig] = None
    frontend: str = "none"        # none | audio | vision

    # long-context policy: "native" (sub-quadratic as-is) or window size used
    # by the documented sliding-window variant for long_500k (see DESIGN.md §5)
    long_context: str = "native"  # native | swa-variant
    swa_variant_window: int = 4096

    # pad the embedding/logits vocab dimension to a multiple so it shards
    # over the model axis (odd vocabs like 50280/49155 otherwise replicate
    # multi-GB f32 logits on every device). 1 = exact vocab (baseline);
    # the §Perf hillclimb and production configs use 256.
    vocab_pad_multiple: int = 1

    # ------------------------------------------------------------------
    @property
    def n_layers(self) -> int:
        return sum(s.n_layers for s in self.segments)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab_size // m) * m

    @property
    def q_dim(self) -> int:
        if self.mla is not None:
            return self.n_heads * (self.mla.qk_nope_head_dim + self.mla.qk_rope_head_dim)
        return self.n_heads * self.head_dim

    def layer_specs(self):
        """Flatten segments to the full per-layer spec list (for analysis)."""
        out = []
        for seg in self.segments:
            for _ in range(seg.repeats):
                out.extend(seg.pattern)
        return out

    def param_count(self) -> int:
        """Analytic parameter count (used by the cost model & roofline)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        total += d  # final norm
        for spec in self.layer_specs():
            total += self._mixer_params(spec) + self._ffn_params(spec) + self._norm_params(spec)
        if self.encoder is not None:
            enc_spec = LayerSpec(mixer="attn", ffn="gelu")
            per = self._mixer_params(enc_spec) + self._ffn_params(enc_spec) + self._norm_params(enc_spec)
            total += self.encoder.n_layers * per + self.d_model
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of n_experts)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        m = self.moe
        total = self.param_count()
        n_moe_layers = sum(1 for s in self.layer_specs() if s.ffn == "moe")
        per_expert = 3 * d * m.d_ff_expert
        total -= n_moe_layers * (m.n_experts - m.top_k) * per_expert
        return total

    def _mixer_params(self, spec: LayerSpec) -> int:
        d = self.d_model
        if spec.mixer == "mamba2":
            s = self.ssm
            di = s.d_inner(d)
            nh = s.n_ssm_heads(d)
            conv_dim = di + 2 * s.n_groups * s.d_state
            in_proj = d * (2 * di + 2 * s.n_groups * s.d_state + nh)
            return in_proj + conv_dim * s.d_conv + conv_dim + 3 * nh + di + di * d
        if spec.mixer == "mla":
            m = self.mla
            qk = m.qk_nope_head_dim + m.qk_rope_head_dim
            n = d * m.q_lora_rank + m.q_lora_rank * self.n_heads * qk
            n += d * (m.kv_lora_rank + m.qk_rope_head_dim)
            n += m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
            n += self.n_heads * m.v_head_dim * d
            return n
        # GQA attention
        n = d * self.n_heads * self.head_dim          # wq
        n += 2 * d * self.n_kv_heads * self.head_dim  # wk, wv
        n += self.n_heads * self.head_dim * d         # wo
        if spec.cross_attn:
            n *= 2
        return n

    def _ffn_params(self, spec: LayerSpec) -> int:
        d = self.d_model
        if spec.ffn == "none":
            return 0
        if spec.ffn == "moe":
            m = self.moe
            return d * m.n_experts + m.n_experts * 3 * d * m.d_ff_expert
        if spec.ffn == "gelu":
            return 2 * d * self.d_ff
        return 3 * d * self.d_ff  # swiglu

    def _norm_params(self, spec: LayerSpec) -> int:
        n = 2 * self.d_model
        if spec.post_norms:
            n += 2 * self.d_model
        if spec.cross_attn:
            n += self.d_model
        return n

    # ------------------------------------------------------------------
    def kv_bytes_per_token(self, dtype_bytes: int = 2) -> int:
        """KV-cache footprint per sequence token across all layers."""
        total = 0
        for spec in self.layer_specs():
            if spec.mixer == "attn":
                total += 2 * self.n_kv_heads * self.head_dim * dtype_bytes
                if spec.cross_attn:
                    pass  # cross KV is per-request, not per-token
            elif spec.mixer == "mla":
                m = self.mla
                total += (m.kv_lora_rank + m.qk_rope_head_dim) * dtype_bytes
        return total

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: ≤2 layers per distinct pattern, d_model≤256,
        ≤4 experts, small vocab. Same family/block structure."""
        small_segments = tuple(
            Segment(pattern=seg.pattern, repeats=min(1, seg.repeats))
            for seg in self.segments[:2]
        )
        d_model = min(self.d_model, 256)
        head_dim = min(self.head_dim, 32)
        n_heads = min(self.n_heads, 4)
        n_kv = min(self.n_kv_heads, n_heads)
        kw = dict(
            name=self.name + "-smoke",
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            segments=small_segments,
        )
        if self.moe is not None:
            n_e = min(4, self.moe.n_experts)
            t_k = min(2, self.moe.top_k)
            # lossless capacity in smoke configs so decode == full forward
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=n_e, top_k=t_k,
                d_ff_expert=min(128, self.moe.d_ff_expert),
                capacity_factor=float(n_e) / t_k)
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(
                self.ssm, d_state=min(32, self.ssm.d_state), headdim=32,
                chunk_size=64)
        if self.mla is not None:
            kw["mla"] = dataclasses.replace(
                self.mla, q_lora_rank=64, kv_lora_rank=32,
                qk_nope_head_dim=16, qk_rope_head_dim=16, v_head_dim=16)
        if self.encoder is not None:
            kw["encoder"] = dataclasses.replace(self.encoder, n_layers=1, n_frames=16)
        if self.mrope_sections != (16, 24, 24):
            pass
        if self.rope_mode == "mrope":
            half = head_dim // 2
            t = half // 4
            kw["mrope_sections"] = (t, (half - t) // 2, half - t - (half - t) // 2)
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input shapes (assigned workload shapes)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


TRAIN_4K = InputShape("train_4k", 4096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32768, 128, "decode")
LONG_500K = InputShape("long_500k", 524288, 1, "decode")

INPUT_SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}
