"""zamba2-7b [arXiv:2411.15242] — Mamba2 backbone + periodic shared attention.

81 layers, d_model 3584, attention blocks with 32 heads (kv=32),
d_ff 14336, vocab 32000, ssm_state 64. We model the hybrid as a repeated
pattern of 5 Mamba2 blocks followed by 1 attention+SwiGLU block
(13 periods = 78 layers) plus a 3-layer Mamba2 epilogue (81 total).
"""

from repro_torch.configs.base import LayerSpec, ModelConfig, SSMConfig, Segment

MAMBA = LayerSpec(mixer="mamba2", ffn="none")
ATTN = LayerSpec(mixer="attn", ffn="swiglu")

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    citation="arXiv:2411.15242",
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    segments=(
        Segment(pattern=(MAMBA, MAMBA, MAMBA, MAMBA, MAMBA, ATTN), repeats=13),
        Segment(pattern=(MAMBA,), repeats=3),
    ),
    rope_theta=10000.0,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, headdim=64, n_groups=1,
                  chunk_size=256),
    long_context="native",  # SSM state O(1); only 13 attention layers hold KV
)
