"""Serving launcher: batched generation through the ``repro_torch.api``
front door (the counterpart of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b \\
        --smoke --prompt-len 32 --new-tokens 32 --batch 4 \\
        [--mode kv_offload] [--device cpu]

It runs on the CUDA device unless ``--device cpu`` is given. ``--mode``
selects the `OffloadConfig` mode. ``--remote-bw GB/s`` swaps the default
topology's remote tier for a bandwidth-throttled modeled tier (one point
of a bandwidth sweep per invocation), and ``--recalibrate`` re-runs the
generation after feeding the measured per-tier-pair bandwidths back into
planning. Weights are random, drawn from a generator seeded by ``--seed``;
prompts are drawn from a CPU generator with the same seed.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import torch

from repro_torch.api import HyperOffloadSession, OffloadConfig
from repro_torch.api.config import CACHE_DTYPES
from repro_torch.configs import REGISTRY
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model
from repro_torch.pool import TierTopology, sweep_topologies


def _synced_s(dev: torch.device, fn):
    """(fn(), seconds), the card drained on both sides."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", choices=sorted(REGISTRY), required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced (smoke-size) config")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    # this launcher drives ServeEngine only; the scheduler modes are
    # reached through HyperOffloadSession.scheduler
    ap.add_argument("--mode", choices=("resident", "kv_offload"),
                    default="resident")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", choices=sorted(CACHE_DTYPES),
                    default="float32",
                    help="weights and KV cache dtype")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--remote-bw", type=float, default=None, metavar="GBPS",
                    help="throttle the remote tier's read bandwidth to this "
                         "many GB/s (modeled tier; one bandwidth-sweep point)")
    ap.add_argument("--recalibrate", action="store_true",
                    help="after the run, replan from measured per-tier-pair "
                         "bandwidths and generate once more")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    dtype = CACHE_DTYPES[args.dtype]

    cfg = REGISTRY[args.arch]
    if args.smoke:
        cfg = cfg.reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed),
                        dtype, dev)
    prompts = torch.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len),
        generator=torch.Generator().manual_seed(args.seed),
        dtype=torch.int32)
    batch = {"tokens": prompts.to(dev)}

    topology = None
    if args.remote_bw is not None:
        topology, = sweep_topologies(
            TierTopology.default(), "remote",
            read_bws=[args.remote_bw * 1e9])
    config = OffloadConfig(mode=args.mode, max_batch=args.batch,
                           max_seq=args.prompt_len + args.new_tokens,
                           cache_dtype=args.dtype, topology=topology)
    toks = args.batch * args.new_tokens
    with HyperOffloadSession(config, device=dev) as session:
        engine = session.serve_engine(model, params)

        def generate():
            return engine.generate(batch, args.new_tokens,
                                   temperature=args.temperature,
                                   seed=args.seed)

        out, dt = _synced_s(dev, generate)
        print(f"arch={cfg.name} mode={args.mode} device={dev} "
              f"dtype={args.dtype} "
              f"tiers={'/'.join(session.pool.spill_order)} "
              f"generated {tuple(out.shape)} in {dt:.2f}s "
              f"({toks / dt:.1f} tok/s)", flush=True)
        print("first sequence:", out[0].tolist(), flush=True)
        s = session.stats()
        print(f"stats: {s['serve']} pool_puts={s['pool']['puts']} "
              f"pool_gets={s['pool']['gets']}", flush=True)
        if args.recalibrate:
            spec = session.recalibrate()
            again, dt2 = _synced_s(dev, generate)
            print(f"recalibrated hw={spec.name} "
                  f"d2r={spec.pool_bw_d2r:.3g}B/s "
                  f"r2d={spec.pool_bw_r2d:.3g}B/s "
                  f"rerun {dt2:.2f}s ({toks / dt2:.1f} tok/s) "
                  f"same_tokens={bool(torch.equal(again, out))}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
