"""End-to-end driver: train a ~100M-parameter model for a few hundred
steps with checkpointing, using the full training substrate (the
counterpart of the repository's ``examples/train_100m.py``).

    PYTHONPATH=src python -m repro_torch.examples.train_100m \\
        [--steps 300] [--seq-len 256] [--batch 8] [--ckpt-dir DIR] \\
        [--device cpu]

It runs on the CUDA device unless ``--device cpu`` is given. Builds a
mid-size phi3-family config (~100M params), streams the deterministic
synthetic pipeline, runs AdamW + cosine schedule under the offload-aware
remat policy (``remat="offload"``: the tagged activations park in host
memory between forward and backward), checkpoints the parameters every
100 steps, and verifies the resume: the last checkpoint restored equals
the live parameters bit for bit when it was written at the last step. As
in the reference, a run shorter than 100 steps writes no checkpoint, and
the resume then reads whatever ``--ckpt-dir`` holds. Weights are drawn
from a generator seeded 0 on the device.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import tempfile
import time
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.api import HyperOffloadSession, OffloadConfig
from repro_torch.checkpoint.ckpt import load_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.configs.base import LayerSpec, ModelConfig, Segment
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.device import resolve_device, synced_s
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import tree_items

CKPT_EVERY = 100


def make_100m_config() -> ModelConfig:
    base = get_config("phi3-mini-3.8b")
    return dataclasses.replace(
        base,
        name="phi3-100m",
        d_model=512,
        n_heads=8,
        n_kv_heads=8,
        head_dim=64,
        d_ff=1536,
        vocab_size=32064,
        segments=(Segment(pattern=(LayerSpec(mixer="attn", ffn="swiglu"),),
                          repeats=10),),
    )


def param_count(cfg: ModelConfig) -> int:
    """Parameters of ``cfg``, counted on ``meta`` tensors (no memory)."""
    return sum(x.numel() for _, x in tree_items(build_model(cfg).param_specs()))


def run(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Train, checkpoint and verify the resume; print what the reference
    prints and return the parameter count, every step's loss, the seconds
    of the loop, the resume step and whether it was bit for bit."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.train_100m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_100m"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = make_100m_config()
    model = build_model(cfg)
    with HyperOffloadSession(OffloadConfig(remat="offload"),
                             device=dev) as session:
        ts = session.train_config(peak_lr=6e-4, warmup=args.steps // 10,
                                  total_steps=args.steps)
        params, opt_state = session.init_train_state(
            model, torch.Generator(device=dev).manual_seed(0), ts=ts)
        n = sum(x.numel() for _, x in tree_items(params))
        print(f"{cfg.name}: {n / 1e6:.1f}M params, {args.steps} steps @ "
              f"batch {args.batch} × seq {args.seq_len}", flush=True)

        step = session.train_step(model, ts)
        data = SyntheticTokens(cfg.vocab_size, seq_len=args.seq_len,
                               global_batch=args.batch, noise=0.05)
        os.makedirs(args.ckpt_dir, exist_ok=True)
        path = os.path.join(args.ckpt_dir, "latest.npz")
        losses = []

        def train():
            p, o = params, opt_state
            t0 = time.perf_counter()   # the progress lines' clock
            for i in range(args.steps):
                p, o, metrics = step(p, o, data.batch(i, device=dev))
                losses.append(float(metrics["loss"]))   # syncs the device
                if i % 25 == 0 or i == args.steps - 1:
                    tok_s = (args.batch * args.seq_len * (i + 1)
                             / (time.perf_counter() - t0))
                    print(f"step {i:4d}  loss {losses[-1]:.4f}  "
                          f"gnorm {float(metrics['grad_norm']):.2f}  "
                          f"({tok_s:.0f} tok/s)", flush=True)
                if (i + 1) % CKPT_EVERY == 0:
                    save_checkpoint(path, p, i + 1)
            return p, o

        (params, opt_state), train_s = synced_s(dev, train)
        print(f"loss: {losses[0]:.3f} → {losses[-1]:.3f} "
              f"(uniform floor ≈ {math.log(cfg.vocab_size):.2f})", flush=True)

        restored, at = load_checkpoint(path, params)
        bitwise = None
        if at == args.steps:
            bitwise = all(torch.equal(a, b) for (_, a), (_, b) in
                          zip(tree_items(restored), tree_items(params)))
            if not bitwise:
                raise AssertionError(
                    f"the checkpoint of step {at} differs from the live "
                    "parameters")
        print(f"checkpoint resume verified at step {at}"
              + (" (bit for bit)" if bitwise else ""), flush=True)
    return dict(params=n, losses=losses, train_s=train_s,
                tokens=args.batch * args.seq_len * args.steps,
                resumed_at=at, bitwise=bitwise)


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
