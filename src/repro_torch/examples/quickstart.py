"""Quickstart: one `OffloadConfig`, one `HyperOffloadSession`, every
offload mechanism behind them (the counterpart of the repository's
``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

It runs on the CUDA device unless ``--device cpu`` is given. The session
is the single front door: it owns the memory pool, the async transfer
engine and the planner, and hands out training steps and serving engines
pre-wired to them. Demonstrated end to end:

- activation offload (offload-aware remat policy) + optimizer-state host
  offload, both switched by config fields (``remat``,
  ``offload_opt_state``): the AdamW moments live in host memory, pinned
  on the card's machine;
- KV-cache round trips through the pool during generation
  (``mode="kv_offload"``) — token for token the resident baseline's;
- the merged ``session.stats()`` snapshot (pool + transfer + serve).

Weights are drawn from a generator seeded 0 on the device.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.api import HyperOffloadSession, OffloadConfig
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.device import DeviceLike, resolve_device, synced_s
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import tree_items

STEPS = 60
LOGGED = (0, 20, 40, 59)


def run(device: DeviceLike = None) -> Dict[str, Any]:
    """Train, generate both ways, print; return the logged losses, the ms
    a training step, where the moments live, the generations and the
    session's stats."""
    dev = resolve_device(device)
    cfg = get_config("phi3-mini-3.8b").reduced()
    model = build_model(cfg)
    print(f"model: {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model})")

    # one declarative config: serving mode + training memory policy
    config = OffloadConfig(mode="kv_offload", max_seq=48,
                           remat="offload", offload_opt_state=True)
    res: Dict[str, Any] = {"losses": {}}
    with HyperOffloadSession(config, device=dev) as session:
        hp = dict(peak_lr=2e-3, warmup=5, total_steps=STEPS)
        step = session.train_step(model, **hp)
        params, opt_state = session.init_train_state(
            model, torch.Generator(device=dev).manual_seed(0), **hp)
        data = SyntheticTokens(cfg.vocab_size, seq_len=32, global_batch=8,
                               noise=0.05)

        def train():
            p, o = params, opt_state
            for i in range(STEPS):
                p, o, metrics = step(p, o, data.batch(i, device=dev))
                if i in LOGGED:
                    res["losses"][i] = float(metrics["loss"])
                    print(f"  step {i:3d}  loss {res['losses'][i]:.4f}  "
                          f"lr {float(metrics['lr']):.2e}")
            return p, o

        print("training with activation + optimizer-state offload...")
        (params, opt_state), train_s = synced_s(dev, train)
        mu = next(x for _, x in tree_items(opt_state.mu))
        pinned = dev.type == "cuda" and mu.is_pinned()
        res.update(train_s=train_s, ms_per_step=train_s / STEPS * 1e3,
                   moments_device=str(mu.device), moments_pinned=pinned)
        print(f"  ({train_s:.1f}s; moments live in {mu.device}"
              f"{' (pinned)' if pinned else ''})")

        print("generating (resident cache vs host-offloaded cache)...")
        prompt = {"tokens": data.batch(0, device=dev)["tokens"][:, :16]}
        resident = session.serve_engine(model, params, offload_kv=False)
        offloaded = session.serve_engine(model, params)   # mode = kv_offload
        out_r = resident.generate(prompt, 16)
        out_o = offloaded.generate(prompt, 16)
        if not torch.equal(out_r, out_o):
            raise AssertionError("offload changed results!")
        res.update(identical=True, generated=out_r,
                   round_trips=offloaded.stats.cache_round_trips)
        print(f"  identical generations; cache round trips: "
              f"{offloaded.stats.cache_round_trips}")
        print("  sample:", out_r[0].tolist())

        s = session.stats()
        res["stats"] = s
        print(f"session stats: serve={s['serve']} "
              f"pool: {s['pool']['puts']} puts / {s['pool']['gets']} gets, "
              f"{s['pool']['transfer']['issued']} async fetches "
              f"({s['pool']['transfer']['waits_overlapped']} overlapped)")
    return res


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.quickstart")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    run(ap.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
