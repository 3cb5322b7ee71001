"""Continuous-serving launcher: one continuous-batching serve over a
Poisson trace, with the telemetry front door exposed as flags (the
counterpart of the repository root's ``launch/serve.py``; the static
``ServeEngine`` launcher ``repro.launch.serve`` has its counterpart in
``repro_torch.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve_trace \\
        [--arch phi3-mini-3.8b] [--mode continuous|kv_offload] \\
        [--trace-out TRACE.json] [--stats-json STATS.json] \\
        [--slo] [--overload X] [--interactive-fraction F] \\
        [--smoke] [--dtype float32|bfloat16] [--device cpu]

It runs on the CUDA device unless ``--device cpu`` is given. ``--smoke``
serves the arch's reduced config; without it the full config, at full
width and depth. ``--dtype`` is the weights' and the KV cache's type.
With ``--smoke --dtype float32 --device cpu`` this is the reference
launcher: the same trace, the same session and the same ``serve,...``
lines.

``--trace-out`` enables the session's telemetry block
(``OffloadConfig.telemetry``) and writes the Chrome trace-event /
Perfetto JSON file there on session close; ``serve,overlap`` then prints
the hidden against exposed transfer time. ``--stats-json`` writes the
merged ``session.stats()`` snapshot. With neither flag no tracer is
constructed.

SLO flags: ``--interactive-fraction F`` annotates the trace with mixed
interactive/batch priority classes and TTFT deadlines; ``--slo`` turns on
the SLO-aware scheduler (deadline-first admission, preemption, early
shedding; alone it implies an interactive fraction of 0.35);
``--overload X`` multiplies the arrival rate by X. With any of them a
per-class SLO attainment summary prints after the run.

Weights are random, drawn on the device from a generator seeded 0
whatever ``--seed`` is (as the reference's ``jax.random.key(0)``);
``--seed`` seeds only the trace. In ``kv_offload`` mode the device tier
holds half the running batch's worst-case cache rows and the host tier
twice the batch's, the rows sized in the cache's own dtype (the reference
sizes them in fp32, which equals this at ``--dtype float32``; a bf16 run
sized by fp32 rows would hold twice the rows and spill less).
"""

from __future__ import annotations

import argparse
import json
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.api import HyperOffloadSession, OffloadConfig
from repro_torch.api.config import CACHE_DTYPES, TelemetryConfig
from repro_torch.configs import REGISTRY
from repro_torch.device import resolve_device, synced_s
from repro_torch.models.model import build_model
from repro_torch.offload.kvcache import worst_case_page_bytes
from repro_torch.sched import poisson_trace
from repro_torch.slo import SLOConfig, attainment_summary


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve_trace",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=sorted(REGISTRY),
                    default="phi3-mini-3.8b")
    ap.add_argument("--mode", choices=("continuous", "kv_offload"),
                    default="kv_offload")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--rate", type=float, default=0.8,
                    help="Poisson arrivals per scheduler step")
    ap.add_argument("--max-batch", type=int, default=3)
    ap.add_argument("--max-seq", type=int, default=48)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="enable telemetry and write the Chrome trace here")
    ap.add_argument("--stats-json", default=None, metavar="PATH",
                    help="write the merged session.stats() snapshot here")
    ap.add_argument("--slo", action="store_true",
                    help="SLO-aware scheduling: deadline-first admission, "
                         "preemption, early shedding")
    ap.add_argument("--overload", type=float, default=None, metavar="X",
                    help="multiply --rate by X (drive the trace past "
                         "capacity)")
    ap.add_argument("--interactive-fraction", type=float, default=None,
                    metavar="F",
                    help="annotate the trace: F of requests interactive "
                         "(TTFT deadline), rest batch")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced (smoke-size) config")
    ap.add_argument("--dtype", choices=sorted(CACHE_DTYPES),
                    default="float32", help="weights and KV cache dtype")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    return ap


def run(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Serve the trace, print the ``serve,...`` lines, and return the
    numbers behind them: the model ``config``, ``requests``, ``tokens``,
    ``requested_tokens`` (the trace's ``max_new_tokens`` summed),
    ``steps``, ``wall_s``, the
    attainment summary and SLO counters (``slo``, with SLO flags), the
    overlap report (``overlap``, with ``--trace-out``) and the final
    ``session.stats()`` snapshot (``stats``)."""
    args = _parser().parse_args(argv)
    if args.slo and args.interactive_fraction is None:
        args.interactive_fraction = 0.35   # --slo alone still demos SLOs
    dev = resolve_device(args.device)
    dtype = CACHE_DTYPES[args.dtype]

    cfg = REGISTRY[args.arch]
    if args.smoke:
        cfg = cfg.reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dtype, dev)

    kwargs: Dict[str, Any] = dict(mode=args.mode, max_batch=args.max_batch,
                                  max_seq=args.max_seq, prefill_budget=2,
                                  cache_dtype=args.dtype)
    if args.mode == "kv_offload":
        # device tier ≈ half the running batch: cold pages spill to host
        # and prefetch back — the traffic the trace is interesting for
        row = worst_case_page_bytes(model.cache_specs(1, args.max_seq, dtype))
        kwargs.update(device_capacity=max(1, args.max_batch // 2) * row,
                      host_capacity=2 * args.max_batch * row)
    if args.trace_out is not None:
        kwargs["telemetry"] = TelemetryConfig(enable=True,
                                              trace_path=args.trace_out)
    if args.slo:
        kwargs["slo"] = SLOConfig(enable=True)

    session = HyperOffloadSession(OffloadConfig(**kwargs), device=dev)
    try:
        sched = session.scheduler(model, params)
        rate = args.rate * (args.overload or 1.0)
        trace = poisson_trace(args.requests, rate=rate,
                              vocab_size=cfg.vocab_size, prompt_lens=(4, 16),
                              new_tokens=(2, 12), prompt_quantum=4,
                              interactive_fraction=args.interactive_fraction,
                              seed=args.seed)
        out, wall = synced_s(dev, lambda: sched.run(trace))
        st = sched.stats
        result: Dict[str, Any] = dict(
            config=cfg, arch=cfg.name, mode=args.mode, requests=len(out),
            tokens=sum(len(v) for v in out.values()),
            requested_tokens=sum(r.max_new_tokens for r in trace),
            steps=st.steps, wall_s=wall)
        print(f"serve,{args.mode},requests:{result['requests']},"
              f"tokens:{result['tokens']},steps:{st.steps},"
              f"wall_s:{wall:.2f}", flush=True)

        if args.slo or args.interactive_fraction is not None:
            att = attainment_summary(sched.finished.values())
            goodput = att["met_tokens"] / max(sched.now, 1e-9)
            result["slo"] = dict(att, goodput_tok_per_step=goodput,
                                 preemptions=st.preemptions,
                                 resumes=st.resumes, shed=st.shed)
            print(f"serve,slo,goodput_tokens:{att['met_tokens']},"
                  f"goodput_tok/step:{goodput:.2f},"
                  f"preemptions:{st.preemptions},resumes:{st.resumes},"
                  f"shed:{st.shed}", flush=True)
            for cls, c in sorted(att["classes"].items()):
                tta = c["ttft_attainment"]
                print(f"serve,slo_class,{cls},requests:{c['requests']},"
                      f"met_tokens:{c['met_tokens']}/{c['tokens']},"
                      f"shed:{c['shed']},ttft_attainment:"
                      f"{'n/a' if tta is None else format(tta, '.2f')}",
                      flush=True)

        if args.trace_out is not None:
            ov = session.overlap()
            hf = ov["hidden_fraction"]
            result["overlap"] = ov
            print(f"serve,overlap,transfers:{ov['transfers']},"
                  f"hidden_s:{ov['hidden_s']:.4f},"
                  f"exposed_s:{ov['exposed_s']:.4f},hidden_fraction:"
                  f"{'n/a' if hf is None else format(hf, '.2f')}", flush=True)
        result["stats"] = session.stats()
        if args.stats_json is not None:
            with open(args.stats_json, "w") as f:
                json.dump(result["stats"], f, indent=2, sort_keys=True,
                          default=str)
            print(f"serve,stats,{args.stats_json}", flush=True)
    finally:
        session.close()   # exports the trace to --trace-out
    if args.trace_out is not None:
        print(f"serve,trace,{args.trace_out}", flush=True)
    return result


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
