"""Plain PyTorch reference of a dense decoder as Phi-3-mini describes it
(arXiv:2404.14219 and its config.json): RMSNorm, attention under RoPE
(rotate-half, base ``rope_theta``) with grouped K/V heads, a SwiGLU MLP,
untied or tied output head.

It runs in float32 with TF32 off, over whole sequences, with no cache,
batching or kernel, and imports nothing of the program. The parameter tree
is the benchmark's (the same tensors the program serves); the weights are
widened layer by layer, so only one layer is ever held in float32. The
norms take the stored ``scale`` as ``weight = 1 + scale``. Departures from
the published model are listed in the configuration's file (``assumed``).

``matmul`` replaces every product with a weight matrix: the lower-precision
control passes :func:`fp8_matmul`.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

Matmul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
FP8_MAX = 448.0


def fp32_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return a @ w


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (its absolute maximum maps to 448), back in float32."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def fp8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The product with both operands in float8 e4m3: the activations
    scaled per row, the weights per output column (W8A8)."""
    return _fp8(a, -1) @ _fp8(w, 0)


@contextlib.contextmanager
def full_fp32():
    """Float32 products in full precision (no TF32) inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    var = x.pow(2).mean(-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * (1.0 + scale.float())


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, H, D) at positions 0..T-1."""
    t, _, d = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=x.device) / d))
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * inv
    emb = torch.cat([ang, ang], dim=-1)[:, None, :]
    return x * emb.cos() + rotate_half(x) * emb.sin()


def attention(config: Dict, p: Dict[str, torch.Tensor], x: torch.Tensor,
              matmul: Matmul) -> torch.Tensor:
    """Causal self-attention of x (T, d); K/V heads shared by groups of
    query heads."""
    t = x.shape[0]
    h, hkv, d = (config["num_attention_heads"],
                 config["num_key_value_heads"], config["head_dim"])
    q = rope(matmul(x, p["wq"]).view(t, h, d), config["rope_theta"])
    k = rope(matmul(x, p["wk"]).view(t, hkv, d), config["rope_theta"])
    v = matmul(x, p["wv"]).view(t, hkv, d)
    g = h // hkv
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    scores = torch.einsum("qhd,khd->hqk", q, k) * d ** -0.5
    mask = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    out = torch.einsum("hqk,khd->qhd", probs, v).reshape(t, h * d)
    return matmul(out, p["wo"])


def swiglu(p: Dict[str, torch.Tensor], x: torch.Tensor,
           matmul: Matmul) -> torch.Tensor:
    return matmul(F.silu(matmul(x, p["w_gate"])) * matmul(x, p["w_up"]),
                  p["w_down"])


def _layer(tree: Dict, r: int) -> Dict:
    """Layer ``r`` of the stacked tree, widened to float32."""
    return {k: _layer(v, r) if isinstance(v, dict) else v[r].float()
            for k, v in tree.items()}


def dense_ffn(config: Dict, p: Dict, x: torch.Tensor, prompt_len: int,
              matmul: Matmul) -> torch.Tensor:
    return swiglu(p["ffn"], x, matmul)


def logits(config: Dict, params: Dict,
           seqs: Sequence[Tuple[torch.Tensor, int, int]],
           matmul: Matmul = fp32_matmul, ffn=dense_ffn) -> List[torch.Tensor]:
    """For each ``(tokens (T,), prompt_len, first)``: the float32 logits
    (T - first, V) of positions ``first .. T-1``, each predicting the token
    after it. ``ffn(config, layer, x, prompt_len, matmul)`` is the
    feed-forward sublayer (dense here, routed experts in ``moe``)."""
    eps = config["rms_norm_eps"]
    layers = params["segments"][0]["p0"]
    with torch.no_grad(), full_fp32():
        xs = [params["embed"][tok.long()].float() for tok, _, _ in seqs]
        for r in range(config["num_hidden_layers"]):
            p = _layer(layers, r)
            for i, (tok, prompt_len, _) in enumerate(seqs):
                x = xs[i]
                x = x + attention(config, p["mixer"],
                                  rms_norm(x, p["pre_norm"]["scale"], eps),
                                  matmul)
                xs[i] = x + ffn(config, p, rms_norm(
                    x, p["ffn_norm"]["scale"], eps), prompt_len, matmul)
            del p
        head = params["embed"].float().T if config["tie_word_embeddings"] \
            else params["lm_head"].float()
        out = []
        for (tok, _, first), x in zip(seqs, xs):
            y = rms_norm(x[first:], params["final_norm"]["scale"], eps)
            out.append(matmul(y, head))
        return out
