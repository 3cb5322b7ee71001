"""whisper-medium [arXiv:2212.04356] — encoder-decoder, audio.

24 encoder + 24 decoder layers, d_model 1024, 16 heads (MHA), d_ff 4096,
vocab 51865. LayerNorm, GELU MLP, learned positions, decoder cross-attention.
The mel-spectrogram + conv frontend is a STUB per the assignment:
``input_specs()`` supplies precomputed 1500-frame encoder embeddings.
"""

from repro_torch.configs.base import EncoderConfig, LayerSpec, ModelConfig, Segment

DEC = LayerSpec(mixer="attn", ffn="gelu", cross_attn=True)

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    citation="arXiv:2212.04356",
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    segments=(Segment(pattern=(DEC,), repeats=24),),
    norm="layernorm",
    norm_eps=1e-5,
    rope_mode="learned",
    tie_embeddings=True,
    encoder=EncoderConfig(n_layers=24, n_frames=1500),
    frontend="audio",
    long_context="swa-variant",  # decoder is full attention; see DESIGN.md §5
)
