"""Finds a cell's files by the names in ``BENCHMARK.json``: its entry there,
``perfbench/cells/<cell>.json`` (its rate and the limit of its output
check), the configuration's file (the model's widths and, under
``serving``, the memory mode and layout it is served with) and the mix's
file. Also
builds the port's ``ModelConfig`` and holds it against the configuration
file's widths, so a change to the port's registry cannot silently change
what is measured."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    entry: Dict[str, Any]       # the BENCHMARK.json workload
    layout: Dict[str, Any]      # the config's serving + cells/<name>.json
    config: Dict[str, Any]      # the configuration's file
    mix: Dict[str, Any]         # perfbench/mixes/<traffic>.json

    @property
    def mode(self) -> str:
        return self.layout["mode"]

    @property
    def offload(self) -> bool:
        return self.layout["mode"] == "kv_offload"

    @property
    def rate(self) -> float:
        return float(self.layout["rate_req_s"])


def _json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict[str, Any]:
    return _json(ROOT / "BENCHMARK.json")


def load_cell(name: str) -> Cell:
    bm = benchmark()
    entries = {w["name"]: w for w in bm["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"known: {sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in bm["configs"]}
    config = _json(ROOT / configs[entry["config"]]["file"])
    return Cell(name=name, entry=entry,
                layout={**config["serving"],
                        **_json(BENCH / "cells" / f"{name}.json")},
                config=config,
                mix=_json(BENCH / "mixes" / f"{entry['traffic']}.json"))


def metric_specs(cell: Cell, kind: str):
    """The ``end_to_end`` or ``per_layer`` metrics that ``cell`` reports:
    those without a ``workloads`` list, and those whose list names it."""
    return [m for m in benchmark()[kind]
            if "workloads" not in m or cell.name in m["workloads"]]


# the port's ModelConfig fields against the configuration file's keys
_WIDTHS = (("d_model", "hidden_size"), ("n_heads", "num_attention_heads"),
           ("n_kv_heads", "num_key_value_heads"), ("head_dim", "head_dim"),
           ("vocab_size", "vocab_size"),
           ("tie_embeddings", "tie_word_embeddings"),
           ("rope_theta", "rope_theta"), ("norm_eps", "rms_norm_eps"))


def port_config(config: Dict[str, Any]):
    """The port's ``ModelConfig`` for this configuration file, after
    checking every width, the depth and the expert counts against it."""
    from repro_torch.configs import REGISTRY
    cfg = REGISTRY[config["port_registry"]]
    want = {field: config[key] for field, key in _WIDTHS}
    want["n_layers"] = config["num_hidden_layers"]
    if config["architecture"] == "moe":
        want["moe.n_experts"] = config["num_local_experts"]
        want["moe.top_k"] = config["num_experts_per_tok"]
        want["moe.d_ff_expert"] = config["intermediate_size"]
        want["moe.capacity_factor"] = config["moe_capacity_factor"]
    else:
        want["d_ff"] = config["intermediate_size"]
    got = {}
    for field in want:
        obj = cfg
        for part in field.split("."):
            obj = getattr(obj, part)
        got[field] = obj
    bad = {f: (got[f], want[f]) for f in want if got[f] != want[f]}
    kinds = {(spec.mixer, spec.ffn) for spec in cfg.layer_specs()}
    ffn = "moe" if config["architecture"] == "moe" else "swiglu"
    if kinds != {("attn", ffn)} or cfg.rope_mode != "rope" \
            or cfg.norm != "rmsnorm" or cfg.query_scale is not None \
            or cfg.attn_logit_softcap or cfg.final_logit_softcap \
            or cfg.scale_embeddings or cfg.padded_vocab != cfg.vocab_size:
        bad["layers"] = (sorted(kinds), f"attn + {ffn}, plain RoPE/RMSNorm")
    if bad:
        raise ValueError(f"the port's {cfg.name} differs from "
                         f"{config['name']}'s file (port, file): {bad}")
    return cfg
