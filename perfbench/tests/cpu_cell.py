"""A benchmark cell shrunk for the CPU: the port's ``.reduced()`` config of
the cell's model, a small layout and a short mix with the same shape. The
tests drive the harness's whole run through it, the chip's check apart."""

from __future__ import annotations

import dataclasses
from typing import Dict

from perfbench.harness import serve
from perfbench.harness.spec import Cell, load_cell

SMALL_MIX = {"lead_in_s": 0.5,
             "prompt_tokens": {"median": 24, "sigma": 0.8, "min": 8, "max": 56},
             "output_tokens": {"median": 4, "sigma": 0.8, "min": 2, "max": 8}}
SMALL_LAYOUT = {"max_batch": 4, "max_seq": 64, "prefill_budget": 2,
                "device_tier_rows": 2, "host_tier_rows": 8}


def widened(name: str, d_model: int, d_ff: int, layers: int):
    """The port's ``.reduced()`` config of ``name`` at a wider ``d_model``
    (heads of 32) and ``d_ff``, ``layers`` deep: near enough to the
    published logit scale for the float8 control to read as it does on the
    chip, and still a size a test run holds."""
    from repro_torch.configs import REGISTRY
    from repro_torch.configs.base import Segment
    base = REGISTRY[name].reduced()
    return dataclasses.replace(
        base, d_model=d_model, d_ff=d_ff, n_heads=d_model // 32,
        n_kv_heads=d_model // 32, head_dim=32,
        segments=(Segment(pattern=base.segments[0].pattern, repeats=layers),))


def config_of(cfg, base: Dict) -> Dict:
    """A configuration file's keys for the port's ``cfg``."""
    out = dict(base, hidden_size=cfg.d_model,
               num_attention_heads=cfg.n_heads,
               num_key_value_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
               vocab_size=cfg.vocab_size, num_hidden_layers=cfg.n_layers,
               rms_norm_eps=cfg.norm_eps, tie_word_embeddings=cfg.tie_embeddings,
               rope_theta=cfg.rope_theta)
    if cfg.moe is not None:
        out.update(num_local_experts=cfg.moe.n_experts,
                   num_experts_per_tok=cfg.moe.top_k,
                   intermediate_size=cfg.moe.d_ff_expert,
                   moe_capacity_factor=cfg.moe.capacity_factor)
    else:
        out["intermediate_size"] = cfg.d_ff
    return out


def small_cell(name: str, monkeypatch, rate: float = 20.0, cfg=None,
               **layout_changes) -> Cell:
    """The cell ``name`` at the port's ``.reduced()`` widths (or ``cfg``),
    with the harness made to build that config."""
    from repro_torch.configs import REGISTRY
    cell = load_cell(name)
    if cfg is None:
        cfg = REGISTRY[cell.config["port_registry"]].reduced()
    monkeypatch.setattr(serve, "port_config", lambda config: cfg)
    layout = dict(cell.layout, **dict(SMALL_LAYOUT, **layout_changes),
                  rate_req_s=rate)
    return dataclasses.replace(
        cell, layout=layout, config=config_of(cfg, cell.config),
        mix=dict(cell.mix, **SMALL_MIX))
