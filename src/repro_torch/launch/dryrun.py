"""Production-mesh dry-run: trace every (architecture × input shape) on
the 16×16 or 2×16×16 mesh with fake tensors (the counterpart of
``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch phi3-mini-3.8b \\
        --shape train_4k [--multi-pod] [--out results/dryrun.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

The mesh lives on the fake process group (``launch.mesh``), so this
process plays rank 0 of 256 or 512 devices. Parameters, batch, cache and
(for train) the AdamW moments are ``DTensor``s placed by
``launch.shardings`` whose local shards are ``FakeTensorMode`` tensors:
nothing is allocated, and the step runs once, op by op, the way rank 0
would run it:

- ``train``: the port's train step (remat ``offload``, or ``full`` with
  ``--memory-mode baseline``);
- ``prefill``: ``Model.prefill``;
- ``decode``: one ``decode_step`` at ``seq_len``.

Fake tensors lie on the CPU, so the model takes its plain path (as the
reference's dry-run lowers XLA, not Pallas). Per combination this
records the per-device argument bytes, the three roofline terms of
``roofline.roofline_from_trace`` and the collectives by kind. The
reference's ``lower_s``/``compile_s`` and its memory analysis beyond the
arguments (output, temp, alias, peak) come from an XLA executable, which
a trace does not build: they are ``null``, with the reason in the record.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import Dict

import torch
import torch.distributed as dist

from repro_torch.configs import INPUT_SHAPES, REGISTRY
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.launch.mesh import close_mesh, make_production_mesh
from repro_torch.launch.shardings import (
    batch_shardings,
    cache_shardings,
    local_bytes,
    param_shardings,
    place,
)
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamWState, tree_map
from repro_torch.roofline.analysis import roofline_from_trace
from repro_torch.sharding.rules import (
    DEFAULT_RULES,
    MULTIPOD_RULES,
    axis_rules,
    mesh_axis_sizes,
)
from repro_torch.training.step import TrainStepConfig, make_train_step

NOT_MEASURED = ("a trace builds no executable: XLA's lowering and compile "
                "times and its output/temp/alias sizes have no counterpart")


def _rules_for(cfg: ModelConfig, shape: InputShape, mesh) -> Dict:
    sizes = mesh_axis_sizes(mesh)
    rules = dict(MULTIPOD_RULES if "pod" in sizes else DEFAULT_RULES)
    if shape.kind in ("train", "prefill"):
        # Megatron-style sequence parallelism: the residual stream (and the
        # per-layer activations saved for backward) stay seq-sharded over
        # the model axis between layers
        rules["seq_act"] = ("model",)
    if shape.kind == "decode" and cfg.n_kv_heads % sizes["model"] != 0:
        # kv heads don't divide the model axis: shard the cache sequence
        # dimension instead
        rules["cache_seq"] = ("model",)
        rules["cache_heads"] = None
    return rules


def _fp32(spec: torch.Tensor) -> torch.Tensor:
    return torch.empty(spec.shape, dtype=torch.float32, device="meta")


def lower_one(arch: str, shape_name: str, *, multi_pod: bool = False,
              memory_mode: str = "offload", compile_: bool = True) -> Dict:
    """One combination's record. ``compile_=False`` stops after placing
    the arguments (the reference stops after lowering). Starts the fake
    process group when none is up, and destroys it again at the end."""
    owned = not dist.is_initialized()
    mesh = make_production_mesh(multi_pod=multi_pod)
    try:
        return _lower(arch, shape_name, mesh, multi_pod, memory_mode,
                      compile_)
    finally:
        if owned:
            close_mesh()


def _lower(arch, shape_name, mesh, multi_pod, memory_mode, compile_) -> Dict:
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg, shape = REGISTRY[arch], INPUT_SHAPES[shape_name]
    n_dev = mesh.size()
    model = build_model(cfg, shape)
    rules = _rules_for(cfg, shape, mesh)
    dtype = torch.bfloat16
    b, s = shape.global_batch, shape.seq_len
    rec: Dict = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "memory_mode": memory_mode,
        "swa_variant": model.swa_override is not None,
    }
    t0 = time.time()
    with FakeTensorMode(), axis_rules(rules, mesh):
        param_spec = model.param_specs(dtype)
        p_shard = param_shardings(param_spec, mesh, rules)
        params = place(param_spec, p_shard, mesh)
        arg_bytes = local_bytes(param_spec, p_shard, mesh)
        train = shape.kind == "train"
        if train:
            batch_spec = make_batch_specs(cfg, s, b, dtype)
            b_shard = batch_shardings(batch_spec, mesh, rules)
            mom_spec = tree_map(_fp32, param_spec)
            m_shard = param_shardings(mom_spec, mesh, rules)
            # made from data, so the fake step counter carries its value:
            # the update's host scalars (lr, bias corrections) read it
            opt = AdamWState(step=torch.tensor(0, dtype=torch.int32),
                             mu=place(mom_spec, m_shard, mesh),
                             nu=place(mom_spec, m_shard, mesh))
            arg_bytes += 2 * local_bytes(mom_spec, m_shard, mesh) + 4 \
                + local_bytes(batch_spec, b_shard, mesh)
            ts = TrainStepConfig(
                remat="offload" if memory_mode == "offload" else "full")
            step = make_train_step(model, ts)
            args = (params, opt, place(batch_spec, b_shard, mesh))
            tokens = b * s
        elif shape.kind == "prefill":
            batch_spec = model.input_specs(shape, dtype)
            b_shard = batch_shardings(batch_spec, mesh, rules)
            cache_spec = model.cache_specs(b, s, dtype)
            c_shard = cache_shardings(cache_spec, mesh, rules)
            arg_bytes += local_bytes(cache_spec, c_shard, mesh) \
                + local_bytes(batch_spec, b_shard, mesh)

            def step(params, batch, cache):
                return model.prefill(params, batch, cache)
            args = (params, place(batch_spec, b_shard, mesh),
                    place(cache_spec, c_shard, mesh))
            tokens = b * s
        else:  # decode: ONE new token against a seq_len KV cache
            cache_spec = model.cache_specs(b, s, dtype)
            c_shard = cache_shardings(cache_spec, mesh, rules)
            tok_spec = {"token": torch.empty((b, 1), dtype=torch.int32,
                                             device="meta")}
            t_shard = batch_shardings(tok_spec, mesh, rules)
            arg_bytes += local_bytes(cache_spec, c_shard, mesh) \
                + local_bytes(tok_spec, t_shard, mesh) + 4

            def step(params, cache, token, pos):
                return model.decode_step(params, cache, token, pos)
            args = (params, place(cache_spec, c_shard, mesh),
                    place(tok_spec, t_shard, mesh)["token"],
                    torch.zeros((), dtype=torch.int32))
            tokens = b
        rec["lower_s"] = None
        rec["place_s"] = round(time.time() - t0, 2)
        rec["memory_analysis"] = {
            "argument_gb": arg_bytes / 1e9, "output_gb": None,
            "temp_gb": None, "alias_gb": None, "peak_gb": None,
            "not_measured": NOT_MEASURED,
        }
        if not compile_:
            return rec
        t1 = time.time()
        _, terms = roofline_from_trace(step, *args, cfg=cfg, tokens=tokens,
                                       n_devices=n_dev, train=train,
                                       arg_bytes=arg_bytes)
        rec["compile_s"] = None
        rec["trace_s"] = round(time.time() - t1, 2)
        rec["roofline"] = terms.row()
        rec["collectives"] = terms.coll_breakdown
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(REGISTRY), default=None)
    ap.add_argument("--shape", choices=sorted(INPUT_SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every (arch × shape), single-pod + multi-pod")
    ap.add_argument("--memory-mode", choices=("offload", "baseline"),
                    default="offload")
    ap.add_argument("--out", default=None, help="append JSON records here")
    args = ap.parse_args(argv)

    combos = []
    if args.all:
        for arch in REGISTRY:
            for shape in INPUT_SHAPES:
                combos.append((arch, shape, False))
                combos.append((arch, shape, True))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        combos.append((args.arch, args.shape, args.multi_pod))

    failures = 0
    records = []
    for arch, shape, mp in combos:
        tag = f"{arch} × {shape} × {'2x16x16' if mp else '16x16'}"
        try:
            rec = lower_one(arch, shape, multi_pod=mp,
                            memory_mode=args.memory_mode)
            records.append(rec)
            r = rec.get("roofline", {})
            print(f"OK   {tag}: args "
                  f"{rec['memory_analysis']['argument_gb']:.2f} GB/dev, "
                  f"compute {r.get('compute_s', 0):.4f}s "
                  f"mem {r.get('memory_s', 0):.4f}s "
                  f"coll {r.get('collective_s', 0):.4f}s → {r.get('dominant')}"
                  f" (trace {rec['trace_s']:.1f}s)", flush=True)
        except Exception as e:
            failures += 1
            traceback.print_exc()
            print(f"FAIL {tag}: {type(e).__name__}: {e}", flush=True)
            records.append({"arch": arch, "shape": shape,
                            "mesh": "2x16x16" if mp else "16x16",
                            "error": f"{type(e).__name__}: {e}"})
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        existing = []
        if os.path.exists(args.out):
            with open(args.out) as f:
                existing = json.load(f)
        with open(args.out, "w") as f:
            json.dump(existing + records, f, indent=1)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
