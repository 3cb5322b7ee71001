"""granite-moe-3b-a800m [hf:ibm-granite/granite-3.0-1b-a400m-base family].

32 layers, d_model 1536, 24 heads (GQA kv=8), per-expert d_ff 512,
vocab 49155, MoE with 40 experts, top-8 routing.
"""

from repro_torch.configs.base import LayerSpec, MoEConfig, ModelConfig, Segment

MOE_LAYER = LayerSpec(mixer="attn", ffn="moe")

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    citation="hf:ibm-granite/granite-3.0-1b-a400m-base",
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    segments=(Segment(pattern=(MOE_LAYER,), repeats=32),),
    rope_theta=10000.0,
    tie_embeddings=True,
    moe=MoEConfig(n_experts=40, top_k=8, d_ff_expert=512,
                  capacity_factor=1.25),
    long_context="swa-variant",  # full attention: long_500k via documented SWA variant
)
