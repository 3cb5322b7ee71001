"""Serving with a paged, pool-resident KV cache and sparse block selection
(the paper's §5.2 / DeepSeek+NSA case study; the counterpart of the
repository's ``examples/serve_offload.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_offload \\
        [--continuous [--slo]] [--trace-out PATH] [--device cpu]

It runs on the CUDA device unless ``--device cpu`` is given. A GQA
attention layer decodes against a `PagedKVCache` whose full pages live in
the host tier of the session's pool. Each step selects the top-k most
relevant pages (mean-key summaries), prefetches only those, and attends
over [selected pages ++ device tail]. Selecting all pages is dense
attention; the sparse setting trades a bounded error for fetching a
fraction of the cache — the paper's NSA trade-off. ``attend_fused``
decodes over the device page buffer through a page table; on the card it
launches the paged-decode kernel, whose summation order differs from the
gather path's, so beside the CPU's bitwise claim it prints the largest
difference from ``attend``.

``--continuous`` instead demos the request-level continuous-batching
scheduler (``repro_torch.sched``): mixed-length Poisson arrivals served
on a small slot pool with plan-driven KV prefetch and host-tier eviction
of cold sequences' pages. Adding ``--slo`` annotates the trace with
mixed interactive/batch priority classes, overloads the arrival rate,
and turns on SLO-aware scheduling — the demo ends with a per-class
attainment summary.

``--trace-out PATH`` turns the session's telemetry on for either demo:
the overlap summary (hidden vs exposed transfer time) prints at the end
and the Chrome trace-event JSON lands at PATH.

The paged demo's inputs (the context's K/V, the query, the K/V appended
while decoding) are drawn from a generator seeded 0 on the device;
``paged_demo`` takes them as arguments. The scheduler demo's weights are
drawn the same way.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.api import HyperOffloadSession, OffloadConfig
from repro_torch.api.config import TelemetryConfig
from repro_torch.device import DeviceLike, resolve_device, synced_s
from repro_torch.kernels.ref import decode_attention_ref

#: the paged demo's geometry: batch, query heads, kv heads, head dim,
#: tokens a page, context, decode steps
B, HQ, HKV, D = 2, 8, 4, 64
PAGE, CTX, STEPS = 32, 512, 64


def _telemetry(trace_out):
    return TelemetryConfig(enable=trace_out is not None,
                           trace_path=trace_out)


def _print_overlap(session, trace_out):
    """Overlap summary from the trace ring (tracing on only)."""
    ov = session.overlap()
    if ov is None:
        return
    hf = ov["hidden_fraction"]
    print(f"overlap: {ov['transfers']} transfers, "
          f"{ov['hidden_s'] * 1e3:.1f} ms hidden / "
          f"{ov['exposed_s'] * 1e3:.1f} ms exposed "
          f"(hidden fraction "
          f"{'n/a' if hf is None else format(hf, '.0%')}); "
          f"trace → {trace_out}")


def demo_inputs(device: DeviceLike = None):
    """(k_ctx, v_ctx, q, k_new, v_new) of the paged demo, fp32, drawn on
    the device: (B, CTX, HKV, D) twice, (B, HQ, D), (STEPS, B, HKV, D)
    twice."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)

    def draw(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    return (draw(B, CTX, HKV, D), draw(B, CTX, HKV, D), draw(B, HQ, D),
            draw(STEPS, B, HKV, D), draw(STEPS, B, HKV, D))


def paged_demo(k_ctx: torch.Tensor, v_ctx: torch.Tensor, q: torch.Tensor,
               k_new: torch.Tensor, v_new: torch.Tensor, *,
               trace_out: Optional[str] = None,
               device: DeviceLike = None) -> Dict[str, Any]:
    """The paged demo over the given inputs (moved to the device): prefill
    the context into host-tier pages, attend over all pages and the top 8,
    4 and 2 against the dense oracle, decode fused over the page buffer,
    then ``len(k_new)`` decode steps with async page prefetch. Prints what
    the reference prints and returns the numbers and outputs behind it."""
    dev = resolve_device(device)
    k_ctx, v_ctx, q, k_new, v_new = (t.to(dev, torch.float32) for t in
                                     (k_ctx, v_ctx, q, k_new, v_new))
    b, ctx, hkv, d = k_ctx.shape
    steps = k_new.shape[0]
    scale = d ** -0.5
    n_pages = -(-(ctx + steps) // PAGE)
    page_nbytes = b * PAGE * hkv * d * 4
    # host tier sized to exactly hold every K and V page (overflow would
    # spill to the remote tier) — tier topology is config, not a call site
    session = HyperOffloadSession(OffloadConfig(
        mode="paged", max_seq=ctx + steps, page_size=PAGE,
        host_capacity=2 * n_pages * page_nbytes,
        telemetry=_telemetry(trace_out)), device=dev)
    res: Dict[str, Any] = {"outputs": {}, "top_k": {}}
    try:
        cache = session.paged_kv(batch=b, n_kv_heads=hkv, head_dim=d)
        cache.prefill(k_ctx, v_ctx)
        res.update(prefill_pages=cache.full_pages, prefill_tail=cache.tail_len)
        print(f"prefilled {ctx} tokens → {cache.full_pages} pool pages "
              f"(host-resident) + {cache.tail_len} tail tokens")

        # dense oracle
        ref = decode_attention_ref(q, k_ctx.transpose(1, 2),
                                   v_ctx.transpose(1, 2), ctx - 1,
                                   scale=scale)

        out_all, t_all = synced_s(dev, lambda: cache.attend(
            q, scale=scale, top_k_pages=None))
        err_all = (out_all - ref).abs().max().item()
        res["outputs"]["all"] = out_all
        for k in (8, 4, 2):
            cache.fetches = 0
            out_k, dt = synced_s(dev, lambda: cache.attend(
                q, scale=scale, top_k_pages=k))
            err = (out_k - ref).abs().max().item()
            res["top_k"][k] = dict(fetched=cache.fetches, err=err, s=dt)
            res["outputs"][f"top{k}"] = out_k
            print(f"top-{k:2d} pages: fetched {cache.fetches}/"
                  f"{cache.full_pages} pages, err vs dense {err:.3e}, "
                  f"{dt * 1e3:.1f} ms")
        print(f"all pages: err {err_all:.3e} (exact), {t_all * 1e3:.1f} ms")
        res.update(err_all=err_all, all_s=t_all)

        # fused paged decode: pages install once into the device page
        # buffer, the page table indexes them in place — no per-step
        # gather/concat
        cache.attend_fused(q, scale=scale)     # warm: installs pages
        out_f, t_fused = synced_s(
            dev, lambda: cache.attend_fused(q, scale=scale))
        bitwise = bool(torch.equal(out_f, out_all))
        fused_diff = (out_f - out_all).abs().max().item()
        res["outputs"]["fused"] = out_f
        res.update(fused_bitwise=bitwise, fused_max_abs_diff=fused_diff,
                   fused_s=t_fused, buffer_hits=cache.buffer_hits,
                   buffer_misses=cache.buffer_misses)
        print(f"fused decode: bitwise match {bitwise} (max abs diff "
              f"{fused_diff:.3e} vs the gather path), {t_fused * 1e3:.1f} ms "
              f"({cache.buffer_hits} buffer hits / {cache.buffer_misses} "
              f"installs)")

        # decode loop with async prefetch: select on the post-append state
        # (so a page flushed this step is a candidate), issue all page
        # fetches at once through the transfer engine, and wait only inside
        # attend — the fetches overlap each other and the selection work
        flushes0 = cache.flushes

        def decode():
            out = None
            for t in range(steps):
                cache.append(k_new[t], v_new[t])
                inflight = cache.prefetch_pages(cache.select_pages(q,
                                                                   top_k=4))
                out = cache.attend(q, scale=scale, prefetched=inflight)
            return out

        out_d, t_decode = synced_s(dev, decode)
        res["outputs"]["decode_last"] = out_d
        res.update(decode_flushes=cache.flushes - flushes0,
                   length=cache.length, decode_s=t_decode,
                   fetches=cache.fetches)
        print(f"decoded {steps} tokens; {cache.flushes - flushes0} pages "
              f"flushed to the pool during decode; cache length "
              f"{cache.length}")

        # pool-manager traffic/occupancy: what the runtime actually moved
        s = cache.pool_stats()
        res["pool"] = s
        host, xfer = s["tier/host"], s["transfer"]
        print(f"pool stats: {s['puts']} puts / {s['gets']} gets, "
              f"{s['bytes_stored'] / 1e6:.2f} MB stored, "
              f"{s['bytes_fetched'] / 1e6:.2f} MB fetched, "
              f"host tier {host['used'] / 1e6:.2f}/"
              f"{(host['capacity'] or 0) / 1e6:.2f} MB "
              f"({host['entries']} pages, backend {host['backend']})")
        print(f"transfer engine: {xfer['issued']} async fetches issued, "
              f"{xfer['waits_overlapped']} fully overlapped, "
              f"{xfer['waits_blocked']} blocked "
              f"({xfer['blocked_s'] * 1e3:.1f} ms exposed)")
        _print_overlap(session, trace_out)
    finally:
        session.close()
    return res


def run(trace_out: Optional[str] = None,
        device: DeviceLike = None) -> Dict[str, Any]:
    """The paged demo on inputs drawn from a generator seeded 0."""
    return paged_demo(*demo_inputs(device), trace_out=trace_out,
                      device=device)


def run_continuous(trace_out: Optional[str] = None, slo: bool = False,
                   device: DeviceLike = None) -> Dict[str, Any]:
    """Continuous-batching scheduler demo: mixed traffic, pool-parked KV.
    Prints what the reference prints and returns the counts behind it."""
    from repro_torch.configs import REGISTRY
    from repro_torch.models.model import build_model
    from repro_torch.offload.kvcache import worst_case_page_bytes
    from repro_torch.sched import poisson_trace
    from repro_torch.slo import SLOConfig, attainment_summary

    dev = resolve_device(device)
    cfg = REGISTRY["phi3-mini-3.8b"].reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        torch.float32, dev)
    max_batch, max_seq = 3, 48
    row = worst_case_page_bytes(model.cache_specs(1, max_seq, torch.float32))
    # device tier ≈ 1.5 cache rows: cold sequences' pages spill to host
    session = HyperOffloadSession(OffloadConfig(
        mode="kv_offload", max_batch=max_batch, max_seq=max_seq,
        prefill_budget=2,
        device_capacity=int(1.5 * row),
        host_capacity=2 * max_batch * row,
        telemetry=_telemetry(trace_out),
        slo=SLOConfig(enable=slo)), device=dev)
    try:
        sched = session.scheduler(model, params)
        # --slo: overload the arrival rate and mix interactive
        # (TTFT-deadline) with batch (throughput-only) requests, so the
        # deadline-first policy has something to prioritize
        rate = 2.4 if slo else 0.8
        trace = poisson_trace(10, rate=rate, vocab_size=cfg.vocab_size,
                              prompt_lens=(4, 16), new_tokens=(2, 12),
                              prompt_quantum=4,
                              interactive_fraction=0.4 if slo else None,
                              seed=0)
        out, dt = synced_s(dev, lambda: sched.run(trace))
        tokens = sum(len(v) for v in out.values())
        st = sched.stats
        pf = sched.prefetch_stats()
        xfer = sched.pool_stats()["transfer"]
        res: Dict[str, Any] = dict(
            requests=len(out), tokens=tokens, steps=st.steps, wall_s=dt,
            joins=st.joins, retires=st.retires,
            admission_blocked=sched.admission.blocked,
            pages_parked=st.pages_parked, cold_spills=st.cold_spills,
            fetches_issued=pf["fetches_issued"],
            layers_planned=pf["layers_planned"],
            preemptions=st.preemptions, resumes=st.resumes, shed=st.shed)
        print(f"continuous scheduler: {len(out)} requests, {tokens} tokens "
              f"in {st.steps} steps ({dt:.2f}s wall) — {st.joins} joins / "
              f"{st.retires} retires, {sched.admission.blocked} admission "
              f"blocks")
        print(f"pages: {st.pages_parked} parked, {st.cold_spills} cold "
              f"spills to lower tiers")
        print(f"plan-driven prefetch: {pf['fetches_issued']} fetches over "
              f"{pf['layers_planned']} planned layers, mean plan lead "
              f"{pf['mean_plan_lead']:.1f} slots; "
              f"{xfer['waits_overlapped']} waits overlapped / "
              f"{xfer['waits_blocked']} blocked")
        lat = sorted(s.t_done - s.request.arrival
                     for s in sched.finished.values())
        print(f"latency (steps): p50 {lat[len(lat) // 2]:.1f}, "
              f"max {lat[-1]:.1f}")
        if slo:
            att = attainment_summary(sched.finished.values())
            res["slo"] = att
            print(f"slo: {att['met_tokens']}/{att['tokens']} tokens within "
                  f"deadline ({st.preemptions} preemptions, {st.resumes} "
                  f"resumes, {st.shed} shed)")
            for cls, c in sorted(att["classes"].items()):
                tta = c["ttft_attainment"]
                print(f"  {cls}: {c['met_tokens']}/{c['tokens']} tokens met "
                      f"({c['requests']} requests, {c['shed']} shed), "
                      f"ttft attainment "
                      f"{'n/a' if tta is None else format(tta, '.0%')}")
        _print_overlap(session, trace_out)
    finally:
        session.close()   # closes the scheduler and the session-owned pool
    return res


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.serve_offload")
    ap.add_argument("--continuous", action="store_true",
                    help="run the continuous-batching scheduler demo")
    ap.add_argument("--slo", action="store_true",
                    help="with --continuous: overloaded mixed-class trace "
                         "under SLO-aware scheduling + attainment summary")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="enable telemetry; write the Chrome trace here")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if args.continuous:
        run_continuous(args.trace_out, slo=args.slo, device=args.device)
    elif args.slo:
        ap.error("--slo requires --continuous")
    else:
        run(args.trace_out, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
