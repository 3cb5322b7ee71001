"""minicpm3-4b [hf:openbmb/MiniCPM3-4B] — Multi-head Latent Attention (MLA).

62 layers, d_model 2560, 40 heads, d_ff 6400, vocab 73448. MLA compresses
the KV cache to a low-rank latent (kv_lora_rank 256 + 32 rope dims per
token per layer), so long_500k runs natively: the compressed cache at 500k
tokens is ~18 GB global — smaller than a full-attention 4k cache of a 7B
model. Decode cost per step is O(S) in the latent space.
"""

from repro_torch.configs.base import LayerSpec, MLAConfig, ModelConfig, Segment

MLA_LAYER = LayerSpec(mixer="mla", ffn="swiglu")

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    citation="hf:openbmb/MiniCPM3-4B",
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    head_dim=64,
    d_ff=6400,
    vocab_size=73448,
    segments=(Segment(pattern=(MLA_LAYER,), repeats=62),),
    rope_theta=10000.0,
    tie_embeddings=True,
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256, qk_nope_head_dim=64,
                  qk_rope_head_dim=32, v_head_dim=64),
    long_context="native",  # MLA latent cache is sub-linear in bytes vs full KV
)
