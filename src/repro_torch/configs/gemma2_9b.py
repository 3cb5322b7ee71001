"""gemma2-9b [arXiv:2408.00118].

42 layers, d_model 3584, 16 heads (GQA kv=8), head_dim 256, d_ff 14336,
vocab 256000. Alternating local (sliding-window 4096) / global attention,
attention-logit softcap 50, final-logit softcap 30, gemma-style
pre+post sublayer RMSNorms, tied embeddings.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig, Segment

LOCAL = LayerSpec(mixer="attn", ffn="swiglu", window=4096, post_norms=True)
GLOBAL = LayerSpec(mixer="attn", ffn="swiglu", window=None, post_norms=True)

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    citation="arXiv:2408.00118",
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    segments=(Segment(pattern=(LOCAL, GLOBAL), repeats=21),),  # 42 layers
    rope_theta=10000.0,
    tie_embeddings=True,
    scale_embeddings=True,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    query_scale=256 ** -0.5,
    long_context="native",  # alternating SWA bounds local KV; global layers keep full cache
)
