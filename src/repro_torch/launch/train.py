"""End-to-end training launcher through the ``repro_torch.api`` front door
(the counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b \\
        --smoke --steps 50 --remat offload --offload-opt-state [--device cpu]

It runs on the CUDA device unless ``--device cpu`` is given. ``--smoke``
trains the arch's reduced config; without it the full config. The memory
policy (``--remat``, ``--offload-opt-state``) goes into the session's
`OffloadConfig`; the optimization hyperparameters override per run.
Weights are random, drawn from a generator seeded by ``--seed``; batches
come from ``SyntheticTokens`` with the same seed. Checkpoints of the
parameters go to ``--ckpt-dir`` every ``--ckpt-every`` steps, and a run
resumes from the latest one there, as the reference's does.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import torch

from repro_torch.api import HyperOffloadSession, OffloadConfig
from repro_torch.api.config import CACHE_DTYPES
from repro_torch.checkpoint.ckpt import load_checkpoint, save_checkpoint
from repro_torch.configs import REGISTRY
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import tree_items


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", choices=sorted(REGISTRY), required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--remat", choices=("none", "full", "offload"),
                    default="none")
    ap.add_argument("--offload-opt-state", action="store_true")
    ap.add_argument("--peak-lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", choices=sorted(CACHE_DTYPES),
                    default="float32", help="parameter dtype")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = REGISTRY[args.arch]
    if args.smoke:
        cfg = cfg.reduced()
    model = build_model(cfg)
    # the memory policy (remat / optimizer-state offload) lives in the
    # session config; optimization hyperparameters override per run
    with HyperOffloadSession(OffloadConfig(
            mode="resident", remat=args.remat,
            offload_opt_state=args.offload_opt_state), device=dev) as session:
        ts = session.train_config(peak_lr=args.peak_lr,
                                  warmup=max(1, args.steps // 10),
                                  total_steps=args.steps)
        params, opt_state = session.init_train_state(
            model, torch.Generator(device=dev).manual_seed(args.seed),
            CACHE_DTYPES[args.dtype], ts=ts)
        step_fn = session.train_step(model, ts)
        data = SyntheticTokens(cfg.vocab_size, seq_len=args.seq_len,
                               global_batch=args.batch, seed=args.seed,
                               noise=0.05)

        start = 0
        if args.ckpt_dir:
            latest = os.path.join(args.ckpt_dir, "latest.npz")
            if os.path.exists(latest):
                params, start = load_checkpoint(latest, params)
                print(f"resumed from {latest} at step {start}", flush=True)

        n_params = sum(x.numel() for _, x in tree_items(params))
        print(f"arch={cfg.name} params={n_params / 1e6:.1f}M "
              f"remat={args.remat} opt_offload={args.offload_opt_state} "
              f"device={dev} dtype={args.dtype}", flush=True)
        t0 = time.time()
        metrics = None
        for i in range(start, args.steps):
            batch = data.batch(i, cfg, device=dev)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            if i % args.log_every == 0 or i == args.steps - 1:
                print(f"step {i:5d}  loss {float(metrics['loss']):.4f}  "
                      f"gnorm {float(metrics['grad_norm']):.3f}  "
                      f"lr {float(metrics['lr']):.2e}  "
                      f"({time.time() - t0:.1f}s)", flush=True)
            if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
                save_checkpoint(os.path.join(args.ckpt_dir, "latest.npz"),
                                params, i + 1)
        if metrics is not None:
            print(f"done: final loss {float(metrics['loss']):.4f}",
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
