"""phi3-mini-3.8b [arXiv:2404.14219].

32 layers, d_model 3072, 32 heads (GQA kv=32 ⇒ MHA), d_ff 8192,
vocab 32064. RoPE + SwiGLU.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig, Segment

DENSE = LayerSpec(mixer="attn", ffn="swiglu")

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    citation="arXiv:2404.14219",
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    segments=(Segment(pattern=(DENSE,), repeats=32),),
    rope_theta=10000.0,
    tie_embeddings=False,
    long_context="swa-variant",
)
