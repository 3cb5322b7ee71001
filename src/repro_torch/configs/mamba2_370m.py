"""mamba2-370m [arXiv:2405.21060] — SSD (state-space duality).

48 layers, d_model 1024, attention-free, vocab 50280, ssm_state 128.
Mamba2 blocks have no separate FFN (the block itself is the mixer+MLP).
"""

from repro_torch.configs.base import LayerSpec, ModelConfig, SSMConfig, Segment

MAMBA = LayerSpec(mixer="mamba2", ffn="none")

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    citation="arXiv:2405.21060",
    d_model=1024,
    n_heads=1,          # unused (attention-free); SSD heads come from SSMConfig
    n_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    segments=(Segment(pattern=(MAMBA,), repeats=48),),
    rope_mode="none",
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, headdim=64, n_groups=1,
                  chunk_size=256),
    long_context="native",  # recurrent state: O(1) memory per decode step
)
