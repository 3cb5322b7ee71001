"""mixtral-8x22b [arXiv:2401.04088] — 8-expert top-2 MoE with sliding-window attention.

56 layers, d_model 6144, 48 heads (GQA kv=8), per-expert d_ff 16384,
vocab 32768. Every layer is MoE; SWA window 4096 bounds the KV cache so
long_500k runs natively.
"""

from repro_torch.configs.base import LayerSpec, MoEConfig, ModelConfig, Segment

MOE_SWA = LayerSpec(mixer="attn", ffn="moe", window=4096)

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    citation="arXiv:2401.04088",
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    segments=(Segment(pattern=(MOE_SWA,), repeats=56),),
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=16384,
                  capacity_factor=1.25),
    long_context="native",  # SWA bounds KV to the window
)
