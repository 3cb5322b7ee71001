"""codeqwen1.5-7b [hf:Qwen/CodeQwen1.5-7B] — qwen1.5 architecture.

32 layers, d_model 4096, 32 heads (GQA kv=32 ⇒ MHA), d_ff 13440,
vocab 92416. RoPE (theta 1e6 for long-context code), SwiGLU.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig, Segment

DENSE = LayerSpec(mixer="attn", ffn="swiglu")

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    citation="hf:Qwen/CodeQwen1.5-7B",
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=13440,
    vocab_size=92416,
    segments=(Segment(pattern=(DENSE,), repeats=32),),
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    long_context="swa-variant",
)
