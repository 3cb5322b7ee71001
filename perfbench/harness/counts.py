"""Operation and byte counts, from shapes: the two attention kernels'
rooflines and the model step's FLOPs. The yardstick lives here and not in
the program.

Rooflines count each input byte read once and each output byte written
once, whatever the kernel reads again, and the operations these inputs
need: the causal half of the scores for flash attention, and for ring
decode only each row's valid positions (a row at position ``pos`` holds
``min(pos + 1, C)`` live tokens)."""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

#: one NVIDIA H100 SXM (data sheet, dense): bf16 tensor-core FLOP/s, HBM3 B/s
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the two terms."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def flash_counts(b: int, s: int, t: int, hq: int, hkv: int, d: int,
                 itemsize: int = 2) -> Tuple[float, float]:
    """(FLOPs, bytes) of causal attention of q (B,S,Hq,D) over k/v
    (B,T,Hkv,D), the queries at the last S of the T positions: q, k, v read
    once, the output written once; QK^T and PV over the pairs the causal
    mask keeps."""
    pairs = sum(min(t, t - s + i + 1) for i in range(s))
    flops = 4.0 * b * hq * d * pairs
    nbytes = itemsize * d * (b * s * hq * 2 + b * t * hkv * 2)
    return flops, nbytes


def ring_counts(positions: Iterable[int], c: int, hq: int, hkv: int, d: int,
                itemsize: int = 2) -> Tuple[float, float]:
    """(FLOPs, bytes) of one ring-decode launch: one query per row, row
    ``i`` at position ``positions[i]`` over a ring of ``C`` slots; only the
    valid keys and values are counted."""
    valid = [min(p + 1, c) for p in positions]
    rows = len(valid)
    flops = 4.0 * hq * d * sum(valid)
    nbytes = itemsize * d * (2 * hkv * sum(valid) + 2 * rows * hq)
    return flops, nbytes


def matmul_params(config: Dict) -> Tuple[int, int]:
    """(per-token weight-matrix parameters of one layer as used by one
    token, parameters of the output head)."""
    d = config["hidden_size"]
    h, hkv, hd = (config["num_attention_heads"],
                  config["num_key_value_heads"], config["head_dim"])
    attn = d * h * hd * 2 + d * hkv * hd * 2
    f = config["intermediate_size"]
    if config["architecture"] == "moe":
        e, k = config["num_local_experts"], config["num_experts_per_tok"]
        ffn = d * e + k * 3 * d * f
    else:
        ffn = 3 * d * f
    return attn + ffn, d * config["vocab_size"]


def prefill_flops(config: Dict, s: int) -> float:
    """A whole-prompt prefill of ``s`` tokens: every layer's products for
    each token, causal attention, and the output head for the last token
    only (the program computes no other logits)."""
    per_layer, head = matmul_params(config)
    n = config["num_hidden_layers"]
    attn = 4.0 * config["num_attention_heads"] * config["head_dim"] \
        * s * (s + 1) / 2
    return n * (2.0 * per_layer * s + attn) + 2.0 * head


def decode_flops(config: Dict, pos: int) -> float:
    """One decoded token written at ``pos``: the products and attention
    over its ``pos + 1`` keys in every layer, and the output head."""
    per_layer, head = matmul_params(config)
    n = config["num_hidden_layers"]
    attn = 4.0 * config["num_attention_heads"] * config["head_dim"] * (pos + 1)
    return n * (2.0 * per_layer + attn) + 2.0 * head
