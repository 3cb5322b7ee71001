"""qwen2-vl-72b [arXiv:2409.12191] — M-RoPE, dynamic resolution VLM.

80 layers, d_model 8192, 64 heads (GQA kv=8), d_ff 29568, vocab 152064.
M-RoPE splits head_dim 128 rotary channels into (temporal 16, height 24,
width 24) sections driven by 3-D position ids. The ViT vision encoder +
projector is a STUB per the assignment: ``input_specs()`` supplies
precomputed patch embeddings and a scatter mask.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig, Segment

DENSE = LayerSpec(mixer="attn", ffn="swiglu")

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    citation="arXiv:2409.12191",
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    segments=(Segment(pattern=(DENSE,), repeats=80),),
    rope_mode="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    frontend="vision",
    long_context="swa-variant",
)
