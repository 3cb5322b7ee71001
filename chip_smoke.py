#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which asserts (the first failure ends the run with a
non-zero exit):

1. build   — compile the hand-written kernels (``csrc/*.cu``, nvcc, sm_90a).
2. kernels — each kernel against its plain PyTorch version on the card, at
   the main path's shapes and gemma2's, in bf16 (tolerance 2e-2) and fp32
   (2e-5, TF32 off); kernel, plain and library times at the main path's
   shape: device time (launches queued behind a spin kernel, so host
   overhead between them is not counted) and time per call.
3. serve   — phi3-mini-3.8b at full width and depth in bf16, weights drawn
   from a seeded generator on the card: ``ServeEngine.generate`` resident,
   then with ``offload_kv`` (the whole cache makes a Store/Prefetch round
   trip through the memory pool every decode step). Tokens must agree,
   every prefill must launch the flash kernel once per layer, and the
   prefill's logits must agree with the plain attention path's, in bf16
   and in fp32. A short generate in each mode is then profiled for the
   device's busy time and its largest kernels.
4. paged   — ``PagedKVCache.attend_fused`` (the paged-decode kernel over
   pool pages) against ``attend`` (the gather path) at phi3's attention
   widths, with every page selected and then top-4 of an 8-page budget.

Output: the card's name and power limit, one line per phase, a JSON line
``{"kernels": [...]}`` and, last, ``{"ok": true, "device": {...}}``. The
launch counts in the kernels line are those of phases 3 and 4 alone: every
count is set to 0 just before a phase drives the port and read just after.
Without a CUDA device, or without the port beside this file, it prints no
result and exits with 2.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: HBM3 rate and dense bf16 tensor-core peak
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

ARCH = "phi3-mini-3.8b"
BATCH, PROMPT, NEW_TOKENS = 4, 512, 64
MAX_SEQ = PROMPT + NEW_TOKENS
PAGE, PAGED_CONTEXT, PAGED_STEPS = 32, 531, 16     # 16 pages + 19 in the tail
PROFILE_TOKENS = 8     # the short generate whose device time is profiled

FLASH = {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:73"}
PAGED = {"name": "paged_decode_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:175"}


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return res.stdout.strip().splitlines()[0]


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on a CUDA device only", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    # fp32 references in full fp32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print(card_line(), flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    kernels = [dict(FLASH), dict(PAGED)]
    phase_build()
    phase_kernels(torch, dev, kernels)
    phase_serve(torch, dev, kernels[0])
    phase_paged(torch, dev, kernels[1])
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# 1. build
# ---------------------------------------------------------------------------


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.load_library()
    wall = time.perf_counter() - t0
    log("build", library=build.library_path().name, seconds=f"{wall:.2f}",
        compiled=bool(build.last_build))
    # registers and spills of every kernel instance (nvcc -Xptxas -v)
    text = str(build.last_build.get("log", ""))
    for fn, spill, regs in re.findall(
            r"Compiling entry function '(\w+)'.*?Function properties.*?"
            r"(\d+) bytes spill stores.*?Used (\d+) registers", text, re.S):
        log("build", kernel=fn, registers=regs, spill_store_bytes=spill)


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions
# ---------------------------------------------------------------------------


def timed(torch, fn, iters: int = 20):
    """(device ms, call ms) of one call. Call ms: host clock around
    ``iters`` calls and a synchronize, which counts the host's own work per
    call too. Device ms: CUDA events around ``iters`` calls queued behind a
    spin kernel that outlasts the queueing, so the device runs them back to
    back and the host's overhead between launches is not counted."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(4e9 * host_s) + 10 ** 7)   # ~2x host_s at <= 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    queued_in_time = not start.query()
    torch.cuda.synchronize()
    assert queued_in_time, "the spin kernel ended before the calls were queued"
    return start.elapsed_time(end) / iters, host_s * 1e3 / iters


def device_busy_ms(torch, fn):
    """Summed device time of the kernels and copies ``fn`` ran, from
    torch.profiler, with the five largest by name; (0.0, []) when the
    profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in events) / 1e3
    top = [(e.key[:60], round(e.self_device_time_total / 1e3, 3), e.count)
           for e in events[:5]]
    return total, top


def bound(nbytes: float, flops: float):
    """Least time for the work on the card (ms) and what sets it."""
    t_mem, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return max(t_mem, t_ops) * 1e3, "bytes" if t_mem >= t_ops else "operations"


def check(torch, what: str, out, ref, tol: float) -> float:
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    ok = bool(torch.isfinite(out.float()).all()) and torch.allclose(
        out.float(), ref.float(), atol=tol, rtol=tol)
    log("kernels", case=what, max_abs_err=f"{err:.3e}", tol=tol, ok=ok)
    assert ok, f"{what}: kernel disagrees with its plain version ({err:.3e})"
    return err


def phase_kernels(torch, dev, kernels) -> None:
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.paged_attention import paged_decode_attention_cuda
    from repro_torch.kernels.ref import (
        flash_attention_ref,
        paged_decode_attention_ref,
    )
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(1)
    tols = {torch.bfloat16: 2e-2, torch.float32: 2e-5}

    def randn(*shape, dtype):
        return torch.randn(*shape, device=dev, generator=gen).to(dtype)

    # -- flash: phi3 prefill (the main path), gemma2 local layer, ragged GQA
    flash_cases = [
        ("phi3", 4, 32, 32, PROMPT, 96, None, None),
        ("gemma2", 2, 16, 8, PROMPT, 256, 4096, 50.0),
        ("gemma2-short-window", 2, 16, 8, 300, 256, 128, 50.0),
        ("ragged-g8", 2, 8, 1, 33, 96, None, 30.0),
    ]
    main_err = 0.0
    for name, b, hq, hkv, s, d, window, cap in flash_cases:
        for dtype, tol in tols.items():
            q = randn(b, hq, s, d, dtype=dtype)
            k, v = randn(b, hkv, s, d, dtype=dtype), randn(b, hkv, s, d,
                                                          dtype=dtype)
            kw = dict(scale=d ** -0.5, window=window, logit_cap=cap)
            err = check(torch, f"flash/{name}/{str(dtype)[6:]}",
                        flash_attention_cuda(q, k, v, **kw),
                        flash_attention_ref(q, k, v, **kw), tol)
            if name == "phi3" and dtype == torch.bfloat16:
                main_err = err
    b, h, s, d = 4, 32, PROMPT, 96
    q, k, v = (randn(b, h, s, d, dtype=torch.bfloat16) for _ in range(3))
    scale = d ** -0.5
    nbytes = 4 * q.numel() * q.element_size()          # q, k, v in; o out
    flops = 4 * b * h * d * s * (s + 1) / 2            # causal: QK^T and PV
    bound_ms, bound_by = bound(nbytes, flops)
    ms, call_ms = timed(torch, lambda: flash_attention_cuda(q, k, v,
                                                           scale=scale))
    plain_ms, plain_call_ms = timed(
        torch, lambda: flash_attention_ref(q, k, v, scale=scale))
    library_ms, _ = timed(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=scale))
    kernels[0].update(max_abs_err=main_err, tol=tols[torch.bfloat16], ms=ms,
                      plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                      library_ms=library_ms)
    log("kernels", kernel="flash_attention", shape=f"B{b}xH{h}xS{s}xD{d}/bf16",
        ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        library_ms=f"{library_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
        call_ms=f"{call_ms:.4f}", plain_call_ms=f"{plain_call_ms:.4f}")

    # -- paged decode: phi3 (main path), gemma2 GQA + cap, tail-only edges
    n_slots = 24
    paged_cases = [
        ("phi3", 4, 32, 32, 96, list(range(16)), 19, None),
        ("phi3-scrambled", 4, 32, 32, 96, [7, 3, 20, 0, 11], 32, None),
        ("gemma2", 4, 16, 8, 256, [5, 1, 9, 3], 7, 50.0),
        ("tail-only", 4, 32, 32, 96, [], 5, None),
        ("empty", 4, 32, 32, 96, [], 0, None),
    ]
    for name, b, hq, hkv, d, table, tail_len, cap in paged_cases:
        for dtype, tol in tols.items():
            args = (randn(b, hq, d, dtype=dtype),
                    randn(n_slots, b, PAGE, hkv, d, dtype=dtype),
                    randn(n_slots, b, PAGE, hkv, d, dtype=dtype),
                    torch.tensor(table, dtype=torch.int32, device=dev),
                    randn(b, PAGE, hkv, d, dtype=dtype),
                    randn(b, PAGE, hkv, d, dtype=dtype), tail_len)
            kw = dict(scale=d ** -0.5, logit_cap=cap)
            out = paged_decode_attention_cuda(*args, **kw)
            err = check(torch, f"paged/{name}/{str(dtype)[6:]}", out,
                        paged_decode_attention_ref(*args, **kw), tol)
            if name == "empty":
                # uniform softmax over equally masked scores: mean of v_tail
                mean = args[5].float().mean(dim=1).repeat_interleave(
                    hq // hkv, dim=1)
                check(torch, f"paged/empty-is-mean/{str(dtype)[6:]}", out,
                      mean, tol)
            if name == "phi3" and dtype == torch.bfloat16:
                kernels[1].update(max_abs_err=err, tol=tol)
                main_args = args
    q, kp, vp, table, kt, vt, tail_len = main_args
    b, hq, d = q.shape
    hkv, tokens = kt.shape[2], table.numel() * PAGE + tail_len
    esize = q.element_size()
    nbytes = (2 * q.numel() + 2 * b * tokens * hkv * d) * esize
    bound_ms, bound_by = bound(nbytes, 4 * b * hq * d * tokens)
    scale = d ** -0.5
    ms, call_ms = timed(torch, lambda: paged_decode_attention_cuda(
        *main_args, scale=scale))
    plain_ms, plain_call_ms = timed(torch, lambda: paged_decode_attention_ref(
        *main_args, scale=scale))
    # no single PyTorch call computes this function: library_ms is null
    kernels[1].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                      bound_by=bound_by, library_ms=None)
    log("kernels", kernel="paged_decode_attention",
        shape=f"B{b}xHq{hq}xHkv{hkv}xD{d}/{tokens}tok/bf16",
        ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
        call_ms=f"{call_ms:.4f}", plain_call_ms=f"{plain_call_ms:.4f}")


# ---------------------------------------------------------------------------
# 3. serve: phi3-mini-3.8b, resident and offload_kv
# ---------------------------------------------------------------------------


def synced_s(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_serve(torch, dev, flash) -> None:
    from repro_torch.configs import REGISTRY
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.models.runtime import use_attention_impl
    from repro_torch.obs import Tracer
    from repro_torch.pool import default_pool
    from repro_torch.serving import ServeEngine

    cfg = REGISTRY[ARCH]
    model = build_model(cfg)
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    params, init_s = synced_s(torch, lambda: model.init(gen, bf16, dev))
    n_params = sum(t.numel() for t in _leaves(params))
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen,
                           device=dev, dtype=torch.int32)
    log("serve", arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        heads=cfg.n_heads, head_dim=cfg.head_dim, d_ff=cfg.d_ff,
        vocab=cfg.vocab_size, params=n_params,
        weight_gb=f"{2 * n_params / 1e9:.2f}", init_s=f"{init_s:.2f}")

    def prefill(weights, dtype):
        cache = model.init_cache(BATCH, MAX_SEQ, dtype, dev)
        with torch.inference_mode():
            return model.prefill(weights, {"tokens": tokens}, cache)[0]

    # The prefill's last-token logits, flash kernel against plain attention.
    # fp32 (TF32 off): the two paths differ only in summation order, 1e-4.
    # bf16: both paths round every layer's attention output to bf16, and 32
    # layers carry a one-ulp difference in one element into the logits, so
    # the two bf16 paths are not held against each other. Each is held
    # against the fp32 plain path on the same weights (the bf16 weights,
    # widened), and the kernel path may come no further from it than the
    # plain path does, plus the kernels' bf16 tolerance (2e-2).
    logits = prefill(params, bf16)
    _, kernel_prefill_s = synced_s(torch, lambda: prefill(params, bf16))
    with use_attention_impl("plain"):
        plain_logits = prefill(params, bf16)
        _, plain_prefill_s = synced_s(torch, lambda: prefill(params, bf16))
    assert logits.shape == (BATCH, 1, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all())

    params32 = _tree_map(lambda t: t.float(), params)
    logits32 = prefill(params32, torch.float32)
    with use_attention_impl("plain"):
        plain32 = prefill(params32, torch.float32)
    del params32
    torch.cuda.empty_cache()
    err32 = (logits32 - plain32).abs().max().item()
    log("serve", check="fp32 prefill logits kernel vs plain",
        max_abs_err=f"{err32:.3e}", tol=1e-4)
    assert bool(torch.isfinite(logits32).all())
    assert torch.allclose(logits32, plain32, atol=1e-4, rtol=1e-4), err32

    def off(a, b):
        d = a.float() - b.float()
        return d.abs().max().item(), d.pow(2).mean().sqrt().item()

    e_kernel, rms_kernel = off(logits, plain32)
    e_plain, rms_plain = off(plain_logits, plain32)
    gap, rms_gap = off(logits, plain_logits)
    log("serve", check="bf16 prefill logits against fp32 plain",
        kernel_max_abs_err=f"{e_kernel:.3e}", kernel_rms=f"{rms_kernel:.3e}",
        plain_max_abs_err=f"{e_plain:.3e}", plain_rms=f"{rms_plain:.3e}",
        tol=f"plain+2e-2={e_plain + 2e-2:.3e}",
        kernel_vs_plain_max_abs=f"{gap:.3e}",
        kernel_vs_plain_rms=f"{rms_gap:.3e}",
        max_abs_logit=f"{plain32.abs().max().item():.3f}",
        same_argmax=bool(torch.equal(logits.argmax(-1),
                                     plain_logits.argmax(-1))))
    assert e_kernel <= e_plain + 2e-2, (e_kernel, e_plain)

    # the main path: counts set to 0 just before, read just after
    gb = 1e9
    ops.reset_launch_counts()
    resident = ServeEngine(model, params, max_seq=MAX_SEQ, cache_dtype=bf16)
    torch.cuda.reset_peak_memory_stats()
    res, res_s = synced_s(torch, lambda: resident.generate(
        {"tokens": tokens}, NEW_TOKENS))
    res_peak = torch.cuda.max_memory_allocated()
    after_resident = ops.launch_counts()["flash_attention"]
    tracer = Tracer()
    pool = default_pool(device=dev, tracer=tracer)
    offload = ServeEngine(model, params, max_seq=MAX_SEQ, cache_dtype=bf16,
                          offload_kv=True, pool=pool, tracer=tracer)
    torch.cuda.reset_peak_memory_stats()
    before_off = torch.cuda.memory_allocated()
    off, off_s = synced_s(torch, lambda: offload.generate(
        {"tokens": tokens}, NEW_TOKENS))
    off_peak = torch.cuda.max_memory_allocated()
    counts = ops.launch_counts()
    flash["launches"] = counts["flash_attention"]

    assert res.shape == (BATCH, NEW_TOKENS) and res.dtype == torch.int32
    assert int(res.min()) >= 0 and int(res.max()) < cfg.vocab_size
    assert torch.equal(res, off), "offload_kv tokens differ from resident"
    assert after_resident == cfg.n_layers, after_resident
    assert counts["flash_attention"] == 2 * cfg.n_layers, counts
    assert counts["paged_decode_attention"] == 0, counts
    assert offload.stats.cache_round_trips == NEW_TOKENS - 1
    stats = offload.pool_stats()
    for key in ("puts", "gets", "bytes_stored", "bytes_fetched"):
        assert stats[key] > 0, (key, stats[key])
    trips = [e.dur for e in tracer.events() if e.name == "cache_round_trip"]
    assert len(trips) == NEW_TOKENS - 1
    moved = stats["bytes_stored"] + stats["bytes_fetched"]
    steps = NEW_TOKENS - 1
    log("serve", mode="resident", generate_s=f"{res_s:.3f}",
        prefill_ms=f"{kernel_prefill_s * 1e3:.2f}",
        plain_prefill_ms=f"{plain_prefill_s * 1e3:.2f}",
        decode_ms_per_step=f"{(res_s - kernel_prefill_s) / steps * 1e3:.2f}",
        tok_per_s=f"{BATCH * NEW_TOKENS / res_s:.1f}")
    log("serve", mode="offload_kv", generate_s=f"{off_s:.3f}",
        decode_ms_per_step=f"{(off_s - kernel_prefill_s) / steps * 1e3:.2f}",
        tok_per_s=f"{BATCH * NEW_TOKENS / off_s:.1f}",
        round_trips=offload.stats.cache_round_trips,
        round_trip_ms=f"{sum(trips) / len(trips) * 1e3:.2f}",
        round_trip_bytes=moved // len(trips),
        round_trip_gb_per_s=f"{moved / sum(trips) / 1e9:.2f}",
        waits_blocked=stats["transfer"]["waits_blocked"],
        waits_overlapped=stats["transfer"]["waits_overlapped"])
    log("serve", weights_gb=f"{2 * n_params / gb:.2f}",
        resident_max_allocated_gb=f"{res_peak / gb:.2f}",
        offload_kv_max_allocated_gb=f"{off_peak / gb:.2f}",
        allocated_before_offload_kv_gb=f"{before_off / gb:.2f}",
        allocated_after_gb=f"{torch.cuda.memory_allocated() / gb:.2f}")
    log("serve", flash_launches=counts["flash_attention"],
        first_tokens=res[0, :8].tolist())

    # where the time goes: a short generate in each mode, on the host clock
    # with the profiler off, then the device time the profiler records
    for mode, engine in (("resident", resident), ("offload_kv", offload)):
        def short():
            return engine.generate({"tokens": tokens}, PROFILE_TOKENS)
        _, wall_s = synced_s(torch, short)
        busy_ms, top = device_busy_ms(torch, short)
        log("serve", profile=mode, new_tokens=PROFILE_TOKENS,
            wall_ms=f"{wall_s * 1e3:.2f}", device_busy_ms=f"{busy_ms:.2f}",
            device_idle_share=(f"{1 - busy_ms / (wall_s * 1e3):.3f}"
                               if busy_ms else "not measured"))
        log("serve", profile=mode, top_device_ms=json.dumps(top))
    pool.close()
    del params


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# 4. paged: fused decode over pool pages
# ---------------------------------------------------------------------------


def phase_paged(torch, dev, paged) -> None:
    from repro_torch.kernels import ops
    from repro_torch.offload import PagedKVCache
    from repro_torch.pool import default_pool

    b, hq, hkv, d = BATCH, 32, 32, 96       # phi3's attention widths
    bf16, tol, scale = torch.bfloat16, 2e-2, d ** -0.5
    gen = torch.Generator(device=dev).manual_seed(2)
    total = PAGED_CONTEXT + PAGED_STEPS
    k_seq = torch.randn(b, total, hkv, d, device=dev, generator=gen).to(bf16)
    v_seq = torch.randn(b, total, hkv, d, device=dev, generator=gen).to(bf16)
    qs = torch.randn(2, PAGED_STEPS, b, hq, d, device=dev,
                     generator=gen).to(bf16)
    pool = default_pool(device=dev)

    def run(label, top_k, device_pages, qset):
        cache = PagedKVCache.create(batch=b, max_seq=1024, page_size=PAGE,
                                    n_kv_heads=hkv, head_dim=d, dtype=bf16,
                                    pool=pool, device_pages=device_pages)
        cache.prefill(k_seq[:, :PAGED_CONTEXT], v_seq[:, :PAGED_CONTEXT])
        worst, fused_s, gather_s = 0.0, 0.0, 0.0
        for t in range(PAGED_STEPS):
            cache.append(k_seq[:, PAGED_CONTEXT + t],
                         v_seq[:, PAGED_CONTEXT + t])
            q = qset[t].contiguous()
            fused, dt = synced_s(torch, lambda: cache.attend_fused(
                q, scale=scale, top_k_pages=top_k))
            fused_s += dt
            gather, dt = synced_s(torch, lambda: cache.attend(
                q, scale=scale, top_k_pages=top_k))
            gather_s += dt
            assert fused.shape == (b, hq, d)
            err = (fused.float() - gather.float()).abs().max().item()
            worst = max(worst, err)
            assert torch.allclose(fused.float(), gather.float(), atol=tol,
                                  rtol=tol), (label, t, err)
        log("paged", run=label, steps=PAGED_STEPS, length=cache.length,
            flushes=cache.flushes, max_abs_err=f"{worst:.3e}", tol=tol,
            buffer_hits=cache.buffer_hits, buffer_misses=cache.buffer_misses,
            fused_ms_per_step=f"{fused_s / PAGED_STEPS * 1e3:.3f}",
            gather_ms_per_step=f"{gather_s / PAGED_STEPS * 1e3:.3f}")
        return cache

    ops.reset_launch_counts()
    run("all-pages", None, None, qs[0])
    sparse = run("top4-of-8-slots", 4, 8, qs[1])
    counts = ops.launch_counts()
    paged["launches"] = counts["paged_decode_attention"]
    assert sparse.buffer_misses > 0
    assert counts["paged_decode_attention"] == 2 * PAGED_STEPS, counts
    assert counts["flash_attention"] == 0, counts
    snap = pool.snapshot()
    assert snap["bytes_stored"] > 0 and snap["bytes_fetched"] > 0
    log("paged", paged_launches=counts["paged_decode_attention"],
        pool_puts=snap["puts"], pool_gets=snap["gets"],
        host_tier=snap["tier/host"]["backend"])
    pool.close()


if __name__ == "__main__":
    sys.exit(main())
