#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which asserts (the first failure ends the run with a
non-zero exit):

1. build   — compile the hand-written kernels (``csrc/*.cu``, one nvcc per
   source, all at once, sm_90a).
2. kernels — each kernel against its plain PyTorch version on the card:
   flash and ring decode at phi3's, zamba2's (head dim 112) and gemma2's
   shapes, paged decode at phi3's and gemma2's, in bf16 (tolerance 2e-2)
   and fp32 (2e-5, TF32 off); the ring kernel also at the edges of its
   split-K (all slots masked, splits with no valid slot, a ragged last
   split, a ring shorter than one split) and with a device (B,) pos at
   phi3's shape (rows at 520, 37, a free slot at 0, and 575; then wrapped
   rows); the SSD scan at zamba2's and
   mamba2-370m's shapes (fp32 out, atol 3e-5, rtol 1e-4). Each flash and
   SSD case logs the kernel instance it took (bf16 flash at head dims
   64-128: wgmma; bf16 B/C in the SSD scan: mma_tf32, on tensor cores),
   the paged case its split-K cut (split, splits, blocks).
   Kernel, plain and library times at each kernel's main shape (flash also
   at head dim 112): device time (launches queued behind a spin kernel, so
   host overhead between them is not counted) and time per call.
3. serve   — phi3-mini-3.8b at full width and depth in bf16, weights drawn
   from a seeded generator on the card: ``ServeEngine.generate`` resident,
   then with ``offload_kv`` (the whole cache makes a Store/Prefetch round
   trip through the memory pool every decode step). Tokens must agree,
   every prefill must launch the flash kernel once per layer and every
   decode step the ring kernel once per layer; the prefill's logits and
   one decode step's must agree with the plain path's, in bf16 and in
   fp32. A short generate in each mode is then profiled for the device's
   busy time and its largest kernels.
4. sched   — phase 3's phi3 weights served by ``ContinuousScheduler`` over
   a seeded Poisson trace (8 requests, prompts 64-512, 16-64 new tokens,
   4 slots): resident, ``kv_offload`` (pages parked on the device tier and
   fetched in the plan's order every step), ``kv_offload`` with a 1.5-row
   device tier (pages spill to pinned host), chunked prefill, chunked
   ``kv_offload``. Tokens and ``SchedStats`` (but pages parked and cold
   spills) must agree within one chunking, and prefill and decoded tokens
   equal what the trace implies; every decode step must launch the ring
   kernel once per layer with a (B,) device pos, every whole-prompt
   admission flash once per layer. First-token logits (whole prompt:
   flash vs plain; chunked: against whole-prompt fp32 plain) and one
   decode step at mixed per-row positions are held by phase 3's logit
   rules. Logs per mode: steps, tok/s, ms per step and decode step, TTFT
   in steps and ms, the host ms per step of each scheduler phase, fetches
   and plan lead, waits, pool bytes per step, peak memory.
5. paged   — ``PagedKVCache.attend_fused`` (the paged-decode kernel over
   pool pages) against ``attend`` (the gather path) at phi3's attention
   widths, with every page selected and then top-4 of an 8-page budget.
6. hybrid  — zamba2-7b (68 Mamba2 and 13 attention layers) at full width
   and depth, as in phase 3: every prefill launches the SSD kernel once per
   Mamba2 layer (each launch the tensor-core instance) and flash once per
   attention layer, every decode step the
   ring kernel once per attention layer; the ``offload_kv`` round trip
   carries the conv, SSM-state (fp32) and K/V leaves. The prefill logits
   are checked on three prompts, the bf16 rule by RMS error.
7. ring    — ``ops.decode_attention`` (the ring-decode kernel) over the
   caches that zamba2's ``attention_decode`` on the plain path has just
   written, held against that function's output, layer by layer for a few
   steps.
8. ssm     — mamba2-370m (48 Mamba2 layers) at full width and depth:
   ``Model.forward`` at B=4, S=2048 in bf16, one SSD launch per layer (each
   the tensor-core instance), logits held against the plain path as in
   phase 3.

Output: the card's name and power limit, one line per phase, the total
wall time, a JSON line ``{"kernels": [...]}`` and, last, ``{"ok": true,
"device": {...}}``. The
launch counts in the kernels line are the sums over phases 3 to 8 of each
phase's own count: every count is set to 0 just before a phase drives the
port and read just after. Without a CUDA device, or without the port
beside this file, it prints no result and exits with 2.
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: HBM3 rate, dense bf16 tensor-core peak (the
# bound's operation rate), dense TF32 (the rate of the SSD scan's split
# products) and fp32 outside the tensor cores (logged beside the SSD scan's
# bound)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
TF32_FLOP_PER_S = 495e12
FP32_FLOP_PER_S = 67e12

ARCH = "phi3-mini-3.8b"
HYBRID_ARCH = "zamba2-7b"
HYBRID_PROMPTS = 3     # prompts on which zamba2's logits are checked
SSM_ARCH, SSM_SEQ = "mamba2-370m", 2048
BATCH, PROMPT, NEW_TOKENS = 4, 512, 64
MAX_SEQ = PROMPT + NEW_TOKENS
PAGE, PAGED_CONTEXT, PAGED_STEPS = 32, 531, 16     # 16 pages + 19 in the tail
PROFILE_TOKENS = 8     # the short generate whose device time is profiled
RING_STEPS = 4         # decode steps of the ring phase (x 13 layers)
SSD_ATOL, SSD_RTOL = 3e-5, 1e-4   # as tests/test_kernels.py's SSD sweep
SSD_SUB = 64           # rows per step of the SSD kernel's mma_tf32 instance
# the sched phase: phi3-mini served by ContinuousScheduler (max_batch
# BATCH, max_seq MAX_SEQ) over a seeded Poisson trace, whole-prompt and
# chunked; SCHED_ROWS are the per-row positions of its checks
SCHED_TRACE = dict(n_requests=8, rate=0.5, prompt_lens=(64, 512),
                   prompt_quantum=64, new_tokens=(16, 64), seed=0)
SCHED_CHUNK, SCHED_PREFILL_TOKENS = 128, 256
SCHED_ROWS = (520, 37, 0, 575)

FLASH = {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:73"}
PAGED = {"name": "paged_decode_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:175"}
DECODE = {"name": "decode_attention", "route": "cuda",
          "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
          "replaces": "src/repro/kernels/paged_attention.py:75"}
SSD = {"name": "ssd_scan", "route": "cuda",
       "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
       "replaces": "src/repro/kernels/ssd_scan.py:67"}


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
    kernels = {k["name"]: dict(k, launches=0)
               for k in (FLASH, PAGED, DECODE, SSD)}
    t_start = time.perf_counter()
    phase_build()
    phase_kernels(torch, dev, kernels)
    model, params = phase_serve(torch, dev, kernels)
    phase_sched(torch, dev, kernels, model, params)
    del model, params
    torch.cuda.empty_cache()
    phase_paged(torch, dev, kernels)
    phase_hybrid(torch, dev, kernels)
    phase_ssm(torch, dev, kernels)
    for k in kernels.values():
        assert k["launches"] > 0, f"{k['name']} never launched on a path"
    log("total", seconds=f"{time.perf_counter() - t_start:.2f}")
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
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


def bound(nbytes: float, flops: float, flop_per_s: float = BF16_FLOP_PER_S):
    """Least time for the work on the card (ms) and what sets it: bytes at
    the HBM rate, operations at the peak rate of their type."""
    t_mem, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_per_s
    return max(t_mem, t_ops) * 1e3, "bytes" if t_mem >= t_ops else "operations"


def check(torch, what: str, out, ref, tol: float, rtol=None) -> float:
    """Kernel output against its plain version: finite, and allclose at
    atol ``tol`` and rtol ``rtol`` (default ``tol``)."""
    torch.cuda.synchronize()
    rtol = tol if rtol is None else rtol
    err = (out.float() - ref.float()).abs().max().item()
    ok = bool(torch.isfinite(out.float()).all()) and torch.allclose(
        out.float(), ref.float(), atol=tol, rtol=rtol)
    log("kernels", case=what, max_abs_err=f"{err:.3e}", tol=tol, rtol=rtol,
        ok=ok)
    assert ok, f"{what}: kernel disagrees with its plain version ({err:.3e})"
    return err


def phase_kernels(torch, dev, kernels) -> None:
    gen = torch.Generator(device=dev).manual_seed(1)
    tols = {torch.bfloat16: 2e-2, torch.float32: 2e-5}

    def randn(*shape, dtype):
        return torch.randn(*shape, device=dev, generator=gen).to(dtype)

    kernels_flash(torch, dev, kernels["flash_attention"], randn, tols)
    kernels_paged(torch, dev, kernels["paged_decode_attention"], randn, tols)
    kernels_decode(torch, dev, kernels["decode_attention"], randn, tols)
    kernels_ssd(torch, dev, kernels["ssd_scan"], gen)


def kernels_flash(torch, dev, entry, randn, tols) -> None:
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ref import flash_attention_ref
    import torch.nn.functional as F

    # -- flash: phi3 prefill (the main path), zamba2's head dim 112, gemma2
    #    local layer, ragged GQA
    flash_cases = [
        ("phi3", 4, 32, 32, PROMPT, 96, None, None),
        ("zamba2", 4, 32, 32, PROMPT, 112, None, None),
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
            err = check(torch, f"flash/{name}/{str(dtype)[6:]}"
                        f"/{flash_instance(torch, flash_attention_cuda, q, k, v, kw)}",
                        flash_attention_cuda(q, k, v, **kw),
                        flash_attention_ref(q, k, v, **kw), tol)
            if name == "phi3" and dtype == torch.bfloat16:
                main_err = err
    # times at phi3's head dim (the main shape, in the kernels line) and at
    # zamba2's 112
    b, h, s = 4, 32, PROMPT
    for d in (96, 112):
        q, k, v = (randn(b, h, s, d, dtype=torch.bfloat16) for _ in range(3))
        scale = d ** -0.5
        instance = flash_instance(torch, flash_attention_cuda, q, k, v,
                                  dict(scale=scale))
        assert instance == "wgmma", (d, instance)
        nbytes = 4 * q.numel() * q.element_size()      # q, k, v in; o out
        flops = 4 * b * h * d * s * (s + 1) / 2        # causal: QK^T and PV
        bound_ms, bound_by = bound(nbytes, flops)
        ms, call_ms = timed(torch, lambda: flash_attention_cuda(q, k, v,
                                                               scale=scale))
        plain_ms, plain_call_ms = timed(
            torch, lambda: flash_attention_ref(q, k, v, scale=scale))
        library_ms, _ = timed(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale))
        if d == 96:
            entry.update(max_abs_err=main_err, tol=tols[torch.bfloat16],
                         ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=library_ms)
        log("kernels", kernel="flash_attention", instance=instance,
            shape=f"B{b}xH{h}xS{s}xD{d}/bf16", ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}", library_ms=f"{library_ms:.4f}",
            bound_ms=f"{bound_ms:.4f}", call_ms=f"{call_ms:.4f}",
            plain_call_ms=f"{plain_call_ms:.4f}")


def flash_instance(torch, flash_attention_cuda, q, k, v, kw) -> str:
    """The kernel instance one call takes (one extra launch, not counted on
    any path: the counts are reset before each phase)."""
    before = dict(flash_attention_cuda.instances)
    flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    taken = [n for n, c in flash_attention_cuda.instances.items()
             if c != before[n]]
    assert len(taken) == 1, taken
    return taken[0]


def kernels_paged(torch, dev, entry, randn, tols) -> None:
    from repro_torch.kernels.paged_attention import (
        paged_decode_attention_cuda,
        ring_split,
    )
    from repro_torch.kernels.ref import paged_decode_attention_ref

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
                entry.update(max_abs_err=err, tol=tol)
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
    entry.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                 bound_by=bound_by, library_ms=None)
    # the split-K cut: table pages and the whole tail page, in splits
    rows = (table.numel() + 1) * PAGE
    split = ring_split(b * hkv, rows,
                       torch.cuda.get_device_properties(dev).multi_processor_count)
    log("kernels", kernel="paged_decode_attention",
        shape=f"B{b}xHq{hq}xHkv{hkv}xD{d}/{tokens}tok/bf16", split=split,
        splits=-(-rows // split), blocks=b * hkv * -(-rows // split),
        ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
        call_ms=f"{call_ms:.4f}", plain_call_ms=f"{plain_call_ms:.4f}")


def kernels_decode(torch, dev, entry, randn, tols) -> None:
    from repro_torch.kernels.paged_attention import (
        decode_attention_cuda,
        ring_split,
    )
    from repro_torch.kernels.ref import decode_attention_ref
    import torch.nn.functional as F

    # -- ring decode, caches in the model's (B,C,Hkv,D) layout: phi3's and
    #    zamba2's decode (the main shape first), gemma2 with GQA, cap and a
    #    wrapped ring, and the wrap positions of tests/test_kernels.py
    cases = [("phi3", 4, 32, 32, MAX_SEQ, 96, PROMPT + 8, None),
             ("zamba2", 4, 32, 32, MAX_SEQ, 112, PROMPT, None),
             ("gemma2-wrapped", 2, 16, 8, 4096, 256, 5000, 50.0)]
    cases += [(f"wrap-pos{p}", 2, 4, 2, 64, 32, p, None)
              for p in (63, 64, 65, 95, 96, 200)]
    # the split-K cuts (tests/test_torch_kernels.py's split model), as
    # ring_split makes them on a 132-SM card: every slot masked and splits
    # with no valid slot (4 splits of 16), a ragged last split, a ring
    # shorter than one split, one split of 9 tiles (1056 rows)
    cases += [("all-masked", 2, 4, 2, 64, 32, -1, 30.0),
              ("invalid-splits", 2, 4, 2, 64, 32, 10, None),
              ("ragged-split", 2, 4, 2, 100, 32, 99, 30.0),
              ("short-ring", 2, 4, 2, 10, 32, 7, None),
              ("one-split", 132, 16, 8, MAX_SEQ, 32, PROMPT + 8, None)]
    for name, b, hq, hkv, c, d, pos, cap in cases:
        for dtype, tol in tols.items():
            q = randn(b, hq, d, dtype=dtype)
            k, v = randn(b, c, hkv, d, dtype=dtype), randn(b, c, hkv, d,
                                                          dtype=dtype)
            kw = dict(scale=d ** -0.5, logit_cap=cap)
            err = check(torch, f"decode/{name}/{str(dtype)[6:]}",
                        decode_attention_cuda(q, k, v, pos, **kw),
                        decode_attention_ref(q, k.transpose(1, 2),
                                             v.transpose(1, 2), pos, **kw),
                        tol)
            if name == "phi3" and dtype == torch.bfloat16:
                entry.update(max_abs_err=err, tol=tol)
                main = (q, k, v, pos)
    q, k, v, pos = main
    b, hq, d = q.shape
    c, hkv = k.shape[1], k.shape[2]
    # the output depends on the slots that hold a token, min(pos + 1, C)
    rows = min(pos + 1, c)
    nbytes = (2 * q.numel() + 2 * b * rows * hkv * d) * q.element_size()
    bound_ms, bound_by = bound(nbytes, 4 * b * hq * rows * d)
    scale = d ** -0.5
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    ms, call_ms = timed(torch, lambda: decode_attention_cuda(q, k, v, pos,
                                                             scale=scale))
    plain_ms, plain_call_ms = timed(torch, lambda: decode_attention_ref(
        q, kt, vt, pos, scale=scale))
    # the library yardstick: one SDPA call with the boolean ring mask (no
    # cap at this shape); timed here only, the port never calls it
    j = torch.arange(c, device=dev)
    mask = ((pos - torch.remainder(pos - j, c)) >= 0)[None, :]   # (1, C)
    q4 = q[:, :, None]
    library_ms, _ = timed(torch, lambda: F.scaled_dot_product_attention(
        q4, kt, vt, attn_mask=mask, scale=scale))
    lib_out = F.scaled_dot_product_attention(q4, kt, vt, attn_mask=mask,
                                             scale=scale)[:, :, 0]
    check(torch, "decode/phi3/bf16/library-call", lib_out,
          decode_attention_ref(q, kt, vt, pos, scale=scale), tols[q.dtype])
    entry.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                 bound_by=bound_by, library_ms=library_ms)
    split = ring_split(b * hkv, c,
                       torch.cuda.get_device_properties(dev).multi_processor_count)
    log("kernels", kernel="decode_attention",
        shape=f"B{b}xHq{hq}xHkv{hkv}xC{c}xD{d}/pos{pos}/bf16", valid_slots=rows,
        split=split, blocks=b * hkv * -(-c // split),
        ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", library_ms=f"{library_ms:.4f}",
        bound_ms=f"{bound_ms:.4f}", call_ms=f"{call_ms:.4f}",
        plain_call_ms=f"{plain_call_ms:.4f}")
    kernels_decode_rows(torch, dev, entry, randn, tols, ms)


def kernels_decode_rows(torch, dev, entry, randn, tols, scalar_ms) -> None:
    """The ring kernel with a device (B,) pos, each row at its own position
    (the continuous scheduler's decode): phi3's shape with rows at C - 1,
    mid-ring and a free slot decoded at 0, then with wrapped rows; bf16 and
    fp32 against the plain version at the same (B,) pos. The first case's
    device time is logged beside the scalar path's (``scalar_ms``)."""
    from repro_torch.kernels.paged_attention import decode_attention_cuda
    from repro_torch.kernels.ref import decode_attention_ref

    b, hq, hkv, c, d = BATCH, 32, 32, MAX_SEQ, 96
    scale = d ** -0.5
    for name, rows in (("per-row", SCHED_ROWS),
                       ("per-row-wrapped", (600, 37, 0, 2 * c - 1))):
        pos = torch.tensor(rows, dtype=torch.int32, device=dev)
        for dtype, tol in tols.items():
            q = randn(b, hq, d, dtype=dtype)
            k, v = randn(b, c, hkv, d, dtype=dtype), randn(b, c, hkv, d,
                                                          dtype=dtype)
            err = check(torch, f"decode/phi3-{name}{list(rows)}/"
                        f"{str(dtype)[6:]}",
                        decode_attention_cuda(q, k, v, pos, scale=scale),
                        decode_attention_ref(q, k.transpose(1, 2),
                                             v.transpose(1, 2), pos,
                                             scale=scale), tol)
            if name == "per-row" and dtype == torch.bfloat16:
                main = (q, k, v, err)
    q, k, v, err = main
    pos = torch.tensor(SCHED_ROWS, dtype=torch.int32, device=dev)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    slots = sum(min(r + 1, c) for r in SCHED_ROWS)   # slots holding a token
    nbytes = (2 * q.numel() + 2 * slots * hkv * d) * q.element_size()
    bound_ms, bound_by = bound(nbytes, 4 * hq * slots * d)
    ms, call_ms = timed(torch, lambda: decode_attention_cuda(q, k, v, pos,
                                                             scale=scale))
    plain_ms, plain_call_ms = timed(torch, lambda: decode_attention_ref(
        q, kt, vt, pos, scale=scale))
    entry.update(per_row_ms=ms, per_row_plain_ms=plain_ms,
                 per_row_bound_ms=bound_ms, per_row_max_abs_err=err)
    log("kernels", kernel="decode_attention", pos="per-row",
        shape=f"B{b}xHq{hq}xHkv{hkv}xC{c}xD{d}/pos{list(SCHED_ROWS)}/bf16",
        valid_slots=slots, ms=f"{ms:.4f}", scalar_pos_ms=f"{scalar_ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
        bound_by=bound_by, call_ms=f"{call_ms:.4f}",
        plain_call_ms=f"{plain_call_ms:.4f}")


def ssd_bytes_and_flops(x, a, b_mat, y, state, chunk):
    """What the SSD scan must move and compute: each input read once (B and
    C once per group when broadcast to the heads with stride 0), y and the
    state written once; FLOP of the lower-triangular intra-chunk products
    (C.B^T and its product with X), the inter-chunk term and the carry;
    and the TF32 work of the tensor-core instance's split products, over
    the 64-row sub-chunks it walks each chunk in (C.B^T one pass with bf16
    B/C, C.state^T two, (S o L).X and the carry three)."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    groups = 1 if b_mat.stride(2) == 0 else h
    nbytes = (x.numel() * 4 + a.numel() * 4 + y.numel() * 4
              + state.numel() * 4
              + 2 * bsz * s * groups * n * b_mat.element_size())
    tri = chunk * (chunk + 1) // 2
    per_chunk = 2 * tri * n + 2 * tri * p + 2 * chunk * n * p * 2
    chunks = bsz * h * (s // chunk)
    split_flops = 0
    for k0 in range(0, chunk, SSD_SUB):
        q = min(SSD_SUB, chunk - k0)
        tri_q = q * (q + 1) // 2
        split_flops += (2 * tri_q * n + 3 * 2 * tri_q * p + 2 * 2 * q * n * p
                        + 3 * 2 * q * n * p)
    return nbytes, per_chunk * chunks, split_flops * chunks


def kernels_ssd(torch, dev, entry, gen) -> None:
    from repro_torch.kernels.ref import ssd_scan_ref
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda

    def inputs(b, s, h, p, n):
        """x, a = dt*A (negative), B/C in bf16 with one group broadcast to
        every head (head stride 0), as the model hands them over."""
        def rnd(*shape):
            return torch.randn(*shape, device=dev, generator=gen)
        x, a = rnd(b, s, h, p), -rnd(b, s, h).abs() * 0.1
        bm = (rnd(b, s, 1, n) * 0.3).to(torch.bfloat16).expand(b, s, h, n)
        cm = (rnd(b, s, 1, n) * 0.3).to(torch.bfloat16).expand(b, s, h, n)
        return x, a, bm, cm

    # zamba2's prefill (the main shape), then mamba2-370m's forward
    for name, shape in (("zamba2", (BATCH, PROMPT, 112, 64, 64)),
                        ("mamba2-370m", (BATCH, SSM_SEQ, 32, 64, 128))):
        args = inputs(*shape)
        chunk = min(256, shape[1])     # the model's chunk_size
        before = dict(ssd_scan_cuda.instances)
        y, state = ssd_scan_cuda(*args, chunk)
        y_ref, state_ref = ssd_scan_ref(*args, chunk)
        torch.cuda.synchronize()
        instance = [k for k, v in ssd_scan_cuda.instances.items()
                    if v != before[k]]
        assert instance == ["mma_tf32"], (name, instance)
        err = max(check(torch, f"ssd/{name}/y", y, y_ref, SSD_ATOL,
                        rtol=SSD_RTOL),
                  check(torch, f"ssd/{name}/state", state, state_ref,
                        SSD_ATOL, rtol=SSD_RTOL))
        nbytes, flops, tc_flops = ssd_bytes_and_flops(args[0], args[1],
                                                      args[2], y, state,
                                                      chunk)
        bound_ms, bound_by = bound(nbytes, flops)
        ms, call_ms = timed(torch, lambda: ssd_scan_cuda(*args, chunk))
        plain_ms, plain_call_ms = timed(
            torch, lambda: ssd_scan_ref(*args, chunk), iters=5)
        log("kernels", kernel="ssd_scan", case=name, instance=instance[0],
            shape="B{}xS{}xH{}xP{}xN{}/L{}/bc-bf16".format(*shape, chunk),
            ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
            mb=f"{nbytes / 1e6:.1f}", gflop=f"{flops / 1e9:.2f}",
            bytes_ms=f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f}",
            bf16_rate_ms=f"{flops / BF16_FLOP_PER_S * 1e3:.4f}",
            tc_split_gflop=f"{tc_flops / 1e9:.2f}",
            tf32_rate_ms=f"{tc_flops / TF32_FLOP_PER_S * 1e3:.4f}",
            fp32_fma_ms=f"{flops / FP32_FLOP_PER_S * 1e3:.4f}",
            call_ms=f"{call_ms:.4f}", plain_call_ms=f"{plain_call_ms:.4f}")
        if name == "zamba2":
            # no single PyTorch call computes this function: library_ms null
            entry.update(max_abs_err=err, tol=SSD_ATOL, rtol=SSD_RTOL, ms=ms,
                         plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=None)
        del args, y, state, y_ref, state_ref
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 3. serve: phi3-mini-3.8b, resident and offload_kv
# ---------------------------------------------------------------------------


def synced_s(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_serve(torch, dev, kernels):
    """Returns phi3's (model, params) for the sched phase."""
    model, params, _ = serve(torch, dev, kernels, ARCH, "serve")
    torch.cuda.empty_cache()
    return model, params


def check_logits(torch, phase: str, run, params, n_prompts: int = 1,
                 stat: str = "max") -> None:
    """Logits under the kernels against the plain path, ``run(weights,
    dtype, i)`` giving the logits on prompt ``i`` (the plain path is taken
    under ``use_attention_impl("plain")``). fp32 (TF32 off): the two paths
    differ only in summation order, 1e-4. bf16: both paths round every
    layer's output to bf16, and a deep stack carries a one-ulp difference
    in one element into the logits, so the two bf16 paths are not held
    against each other. Each is held against the fp32 plain path on the
    same weights (the bf16 weights, widened), and the kernel path may come
    no further from it than the plain path does, plus the kernels' bf16
    tolerance (2e-2), by the statistic ``stat``: the maximum abs error
    (``"max"``) or the RMS error (``"rms"``). Both are logged."""
    from repro_torch.models.runtime import use_attention_impl

    bf16 = torch.bfloat16
    runs = []
    for i in range(n_prompts):
        logits = run(params, bf16, i)
        with use_attention_impl("plain"):
            plain_logits = run(params, bf16, i)
        assert bool(torch.isfinite(logits).all())
        runs.append((logits, plain_logits))
    params32 = _tree_map(lambda t: t.float(), params)

    def off(a, b):
        d = a.float() - b.float()
        return d.abs().max().item(), d.pow(2).mean().sqrt().item()

    for i, (logits, plain_logits) in enumerate(runs):
        logits32 = run(params32, torch.float32, i)
        with use_attention_impl("plain"):
            plain32 = run(params32, torch.float32, i)
        err32 = (logits32 - plain32).abs().max().item()
        log(phase, check="fp32 logits kernel vs plain", prompt=i,
            max_abs_err=f"{err32:.3e}", tol=1e-4)
        assert bool(torch.isfinite(logits32).all())
        assert torch.allclose(logits32, plain32, atol=1e-4, rtol=1e-4), err32
        e_kernel, rms_kernel = off(logits, plain32)
        e_plain, rms_plain = off(plain_logits, plain32)
        gap, rms_gap = off(logits, plain_logits)
        max_ok = e_kernel <= e_plain + 2e-2
        rms_ok = rms_kernel <= rms_plain + 2e-2
        log(phase, check="bf16 logits against fp32 plain", prompt=i,
            held_by=stat, kernel_max_abs_err=f"{e_kernel:.3e}",
            kernel_rms=f"{rms_kernel:.3e}",
            plain_max_abs_err=f"{e_plain:.3e}", plain_rms=f"{rms_plain:.3e}",
            max_tol=f"plain+2e-2={e_plain + 2e-2:.3e}", max_within=max_ok,
            rms_tol=f"plain+2e-2={rms_plain + 2e-2:.3e}", rms_within=rms_ok,
            kernel_vs_plain_max_abs=f"{gap:.3e}",
            kernel_vs_plain_rms=f"{rms_gap:.3e}",
            max_abs_logit=f"{plain32.abs().max().item():.3f}",
            same_argmax_share=f"{(logits.argmax(-1) == plain_logits.argmax(-1)).float().mean().item():.4f}")
        del logits32, plain32
        if stat == "max":
            assert max_ok, (i, e_kernel, e_plain)
        else:
            assert rms_ok, (i, rms_kernel, rms_plain)
    del params32
    torch.cuda.empty_cache()


def check_decode_logits(torch, phase: str, model, params, tokens) -> None:
    """One decode step's logits with the ring kernel against the plain
    decode (``use_attention_impl("plain")``), from one cache that a plain
    prefill filled, at pos = PROMPT. fp32 (TF32 off): within 1e-4. bf16:
    the kernel path's RMS error against fp32 plain within 5 % of the plain
    bf16 path's (the two differ only in the decode attention, which both
    sum in fp32 and round to bf16 once)."""
    from repro_torch.models.runtime import use_attention_impl

    dev = tokens.device

    def step(weights, dtype):
        cache = model.init_cache(BATCH, MAX_SEQ, dtype, dev)
        with torch.inference_mode():
            with use_attention_impl("plain"):
                logits, cache = model.prefill(weights, {"tokens": tokens},
                                              cache)
            tok = logits[:, 0].argmax(-1).to(torch.int32)[:, None]
            twin = _tree_map(lambda t: t.clone(), cache)
            kernel, _ = model.decode_step(weights, cache, tok, PROMPT)
            with use_attention_impl("plain"):
                plain, _ = model.decode_step(weights, twin, tok, PROMPT)
        del cache, twin
        return kernel.float(), plain.float()

    kernel16, plain16 = step(params, torch.bfloat16)
    params32 = _tree_map(lambda t: t.float(), params)
    kernel32, plain32 = step(params32, torch.float32)
    del params32
    err32 = (kernel32 - plain32).abs().max().item()
    assert bool(torch.isfinite(kernel16).all())
    assert bool(torch.isfinite(kernel32).all())
    rms_kernel = (kernel16 - plain32).pow(2).mean().sqrt().item()
    rms_plain = (plain16 - plain32).pow(2).mean().sqrt().item()
    log(phase, check="decode-step logits kernel vs plain", pos=PROMPT,
        fp32_max_abs_err=f"{err32:.3e}", fp32_tol=1e-4,
        bf16_kernel_rms=f"{rms_kernel:.3e}", bf16_plain_rms=f"{rms_plain:.3e}",
        rms_tol=f"1.05*plain={1.05 * rms_plain:.3e}",
        bf16_kernel_vs_plain_max_abs=f"{(kernel16 - plain16).abs().max().item():.3e}")
    assert torch.allclose(kernel32, plain32, atol=1e-4, rtol=1e-4), err32
    assert rms_kernel <= 1.05 * rms_plain, (rms_kernel, rms_plain)
    del kernel16, plain16, kernel32, plain32
    torch.cuda.empty_cache()


def mixers(cfg):
    """(attention layers, Mamba2 layers) of a configuration."""
    specs = [spec for seg in cfg.segments for spec in seg.pattern
             for _ in range(seg.repeats)]
    return (sum(s.mixer == "attn" for s in specs),
            sum(s.mixer == "mamba2" for s in specs))


def serve(torch, dev, kernels, arch: str, phase: str, n_prompts: int = 1,
          stat: str = "max"):
    """``ServeEngine.generate`` of ``arch`` at full width and depth in
    bf16, resident then ``offload_kv``; returns (model, params, tokens).
    The prefill logits are held against the plain path on ``n_prompts``
    prompts by ``stat`` (see :func:`check_logits`)."""
    from repro_torch.configs import REGISTRY
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.models.runtime import use_attention_impl
    from repro_torch.obs import Tracer
    from repro_torch.pool import default_pool
    from repro_torch.serving import ServeEngine

    cfg = REGISTRY[arch]
    n_attn, n_mamba = mixers(cfg)
    model = build_model(cfg)
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    params, init_s = synced_s(torch, lambda: model.init(gen, bf16, dev))
    n_params = sum(t.numel() for t in _leaves(params))
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    prompts = [torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen,
                             device=dev, dtype=torch.int32)
               for _ in range(n_prompts)]
    tokens = prompts[0]
    log(phase, arch=cfg.name, layers=cfg.n_layers, attn_layers=n_attn,
        mamba2_layers=n_mamba, d_model=cfg.d_model, heads=cfg.n_heads,
        head_dim=cfg.head_dim, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
        params=n_params, weight_gb=f"{weight_bytes / 1e9:.2f}",
        init_s=f"{init_s:.2f}")

    def prefill(weights, dtype, i=0):
        cache = model.init_cache(BATCH, MAX_SEQ, dtype, dev)
        with torch.inference_mode():
            return model.prefill(weights, {"tokens": prompts[i]}, cache)[0]

    check_logits(torch, phase, prefill, params, n_prompts, stat)
    check_decode_logits(torch, phase, model, params, prompts[0])
    del prompts[1:]
    _, kernel_prefill_s = synced_s(torch, lambda: prefill(params, bf16))
    with use_attention_impl("plain"):
        _, plain_prefill_s = synced_s(torch, lambda: prefill(params, bf16))

    # the main path: counts set to 0 just before, read just after
    gb = 1e9
    ops.reset_launch_counts()
    resident = ServeEngine(model, params, max_seq=MAX_SEQ, cache_dtype=bf16)
    torch.cuda.reset_peak_memory_stats()
    res, res_s = synced_s(torch, lambda: resident.generate(
        {"tokens": tokens}, NEW_TOKENS))
    res_peak = torch.cuda.max_memory_allocated()
    after_resident = ops.launch_counts()
    tracer = Tracer()
    pool = default_pool(device=dev, tracer=tracer)
    offload = ServeEngine(model, params, max_seq=MAX_SEQ, cache_dtype=bf16,
                          offload_kv=True, pool=pool, tracer=tracer)
    host_buffers = {}     # pool key -> {(address, dtype, pinned)}
    pool_put = pool.put

    def recording_put(key, value, *args, **kwargs):
        entry = pool_put(key, value, *args, **kwargs)
        h = entry.handle
        host_buffers.setdefault(key, set()).add(
            (h.data_ptr(), h.dtype, h.is_pinned()))
        return entry

    pool.put = recording_put
    torch.cuda.reset_peak_memory_stats()
    before_off = torch.cuda.memory_allocated()
    off, off_s = synced_s(torch, lambda: offload.generate(
        {"tokens": tokens}, NEW_TOKENS))
    off_peak = torch.cuda.max_memory_allocated()
    counts = ops.launch_counts()
    for name, n in counts.items():
        kernels[name]["launches"] += n

    assert res.shape == (BATCH, NEW_TOKENS) and res.dtype == torch.int32
    assert int(res.min()) >= 0 and int(res.max()) < cfg.vocab_size
    assert torch.equal(res, off), "offload_kv tokens differ from resident"
    # one prefill per generate: each attention layer launches flash once,
    # each Mamba2 layer the SSD scan once; each decode step launches the
    # ring kernel once per attention layer
    expect = {"flash_attention": n_attn, "ssd_scan": n_mamba,
              "paged_decode_attention": 0,
              "decode_attention": n_attn * (NEW_TOKENS - 1)}
    assert after_resident == expect, (after_resident, expect)
    assert counts == {k: 2 * v for k, v in expect.items()}, counts
    # every SSD launch of the bf16 prefills took the tensor-core instance
    assert ssd_instances() == {"mma_tf32": counts["ssd_scan"],
                               "fma_f32": 0}, ssd_instances()
    assert offload.stats.cache_round_trips == NEW_TOKENS - 1
    stats = offload.pool_stats()
    for key in ("puts", "gets", "bytes_stored", "bytes_fetched"):
        assert stats[key] > 0, (key, stats[key])
    trips = [e.dur for e in tracer.events() if e.name == "cache_round_trip"]
    assert len(trips) == NEW_TOKENS - 1
    # every cache leaf makes the round trip once per step, at its own dtype
    leaves = list(_leaves(model.init_cache(BATCH, MAX_SEQ, bf16, dev)))
    leaf_bytes = sum(t.numel() * t.element_size() for t in leaves)
    assert stats["puts"] == stats["gets"] == len(leaves) * len(trips), stats
    assert stats["bytes_stored"] == stats["bytes_fetched"] \
        == leaf_bytes * len(trips), (stats, leaf_bytes)
    # one pinned host buffer per leaf, made at the first step and reused
    assert len(host_buffers) == len(leaves), len(host_buffers)
    assert all(len(v) == 1 and next(iter(v))[2]
               for v in host_buffers.values()), host_buffers
    assert sorted(str(next(iter(v))[1]) for v in host_buffers.values()) \
        == sorted(str(t.dtype) for t in leaves)
    del pool.put
    moved = stats["bytes_stored"] + stats["bytes_fetched"]
    steps = NEW_TOKENS - 1
    log(phase, mode="resident", generate_s=f"{res_s:.3f}",
        prefill_ms=f"{kernel_prefill_s * 1e3:.2f}",
        plain_prefill_ms=f"{plain_prefill_s * 1e3:.2f}",
        decode_ms_per_step=f"{(res_s - kernel_prefill_s) / steps * 1e3:.2f}",
        tok_per_s=f"{BATCH * NEW_TOKENS / res_s:.1f}")
    log(phase, mode="offload_kv", generate_s=f"{off_s:.3f}",
        decode_ms_per_step=f"{(off_s - kernel_prefill_s) / steps * 1e3:.2f}",
        tok_per_s=f"{BATCH * NEW_TOKENS / off_s:.1f}",
        round_trips=offload.stats.cache_round_trips,
        cache_leaves=len(leaves), pinned_buffers=len(host_buffers),
        leaf_dtypes=sorted({str(t.dtype)[6:] for t in leaves}),
        round_trip_ms=f"{sum(trips) / len(trips) * 1e3:.2f}",
        round_trip_bytes=moved // len(trips),
        round_trip_gb_per_s=f"{moved / sum(trips) / 1e9:.2f}",
        waits_blocked=stats["transfer"]["waits_blocked"],
        waits_overlapped=stats["transfer"]["waits_overlapped"])
    del leaves
    log(phase, weights_gb=f"{weight_bytes / gb:.2f}",
        resident_max_allocated_gb=f"{res_peak / gb:.2f}",
        offload_kv_max_allocated_gb=f"{off_peak / gb:.2f}",
        allocated_before_offload_kv_gb=f"{before_off / gb:.2f}",
        allocated_after_gb=f"{torch.cuda.memory_allocated() / gb:.2f}")
    log(phase, launches=json.dumps(counts),
        ssd_instances=json.dumps(ssd_instances()),
        first_tokens=res[0, :8].tolist())

    # where the time goes: a short generate in each mode, on the host clock
    # with the profiler off, then the device time the profiler records
    for mode, engine in (("resident", resident), ("offload_kv", offload)):
        def short():
            return engine.generate({"tokens": tokens}, PROFILE_TOKENS)
        _, wall_s = synced_s(torch, short)
        busy_ms, top = device_busy_ms(torch, short)
        log(phase, profile=mode, new_tokens=PROFILE_TOKENS,
            wall_ms=f"{wall_s * 1e3:.2f}", device_busy_ms=f"{busy_ms:.2f}",
            device_idle_share=(f"{1 - busy_ms / (wall_s * 1e3):.3f}"
                               if busy_ms else "not measured"))
        log(phase, profile=mode, top_device_ms=json.dumps(top))
    pool.close()
    return model, params, tokens


def ssd_instances():
    """SSD launches by kernel instance since the counts were last reset."""
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda
    return dict(ssd_scan_cuda.instances)


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
# 4. sched: phi3-mini through the continuous scheduler
# ---------------------------------------------------------------------------

#: (mode, SchedulerConfig fields); "-spill" runs on a device tier of 1.5
#: worst-case rows, so parked pages spill to the pinned host tier
SCHED_MODES = (
    ("resident", {}),
    ("kv_offload", dict(kv_offload=True)),
    ("kv_offload-spill", dict(kv_offload=True)),
    ("chunked", dict(chunk_size=SCHED_CHUNK,
                     prefill_tokens=SCHED_PREFILL_TOKENS)),
    ("chunked-kv_offload", dict(chunk_size=SCHED_CHUNK,
                                prefill_tokens=SCHED_PREFILL_TOKENS,
                                kv_offload=True)),
)


def phase_sched(torch, dev, kernels, model, params) -> None:
    """``ContinuousScheduler`` serving phi3-mini at full width and depth
    (bf16, the serve phase's weights) over a seeded Poisson trace, in each
    of ``SCHED_MODES``. Holds: the same tokens and ``SchedStats`` (but
    pages parked and cold spills) for resident and ``kv_offload`` at one
    chunking; prefill and decoded tokens equal to what the trace implies;
    each decode step launching the ring kernel once per layer with a (B,)
    device pos; each whole-prompt admission launching flash once per
    layer; first-token logits and one mixed-pos decode step's logits by
    the logit rules of the serve phase."""
    from repro_torch.offload import worst_case_page_bytes
    from repro_torch.sched import poisson_trace

    cfg = model.cfg
    n_attn, _ = mixers(cfg)
    trace_kw = dict(SCHED_TRACE, vocab_size=cfg.vocab_size)
    trace = poisson_trace(**trace_kw)
    row = worst_case_page_bytes(model.cache_specs(1, MAX_SEQ, torch.bfloat16))
    log("sched", arch=cfg.name, requests=len(trace), max_batch=BATCH,
        max_seq=MAX_SEQ, trace=json.dumps(SCHED_TRACE),
        prompt_lens=[r.prompt_len for r in trace],
        new_tokens=[r.max_new_tokens for r in trace],
        arrivals=[round(r.arrival, 3) for r in trace], chunk=SCHED_CHUNK,
        prefill_tokens_per_step=SCHED_PREFILL_TOKENS, row_bytes=row)
    runs = {mode: sched_run(torch, dev, kernels, model, params, trace_kw,
                            mode, kw, row, n_attn)
            for mode, kw in SCHED_MODES}

    def same_work(stats):
        return {k: v for k, v in stats.items()
                if k not in ("pages_parked", "cold_spills")}

    for mode, run in runs.items():
        st = run["stats"]
        assert st["prefill_tokens"] == sum(r.prompt_len for r in trace), mode
        assert st["decoded_tokens"] == sum(r.max_new_tokens - 1
                                           for r in trace), mode
        assert st["joins"] == st["retires"] == len(trace), (mode, st)
    for a, b in (("resident", "kv_offload"), ("resident", "kv_offload-spill"),
                 ("chunked", "chunked-kv_offload")):
        assert runs[a]["tokens"] == runs[b]["tokens"], \
            f"{b} tokens differ from {a}"
        assert same_work(runs[a]["stats"]) == same_work(runs[b]["stats"]), \
            (a, b, runs[a]["stats"], runs[b]["stats"])
    assert runs["kv_offload-spill"]["stats"]["cold_spills"] > 0
    whole, chunked = runs["resident"]["tokens"], runs["chunked"]["tokens"]
    matching = sum(int(x == y) for seed in whole
                   for x, y in zip(whole[seed], chunked[seed]))
    log("sched", check="tokens, whole-prompt vs chunked (reported)",
        matching=matching, of=sum(len(v) for v in whole.values()),
        identical_requests=sum(whole[s] == chunked[s] for s in whole),
        first_tokens_equal=sum(whole[s][0] == chunked[s][0] for s in whole))
    check_sched_logits(torch, model, params, trace)
    check_mixed_decode_logits(torch, model, params, n_attn)


def sched_run(torch, dev, kernels, model, params, trace_kw, mode, kw, row,
              n_attn):
    """One ``ContinuousScheduler.run`` of the trace in one mode; returns
    its tokens (by request seed) and ``SchedStats``. Every entry point the
    scheduler calls is wrapped to count its kernel launches per call (no
    launch, no sync of its own); the step loop is timed on the host
    clock."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.paged_attention import decode_attention_cuda
    from repro_torch.obs import Tracer
    from repro_torch.pool import default_pool
    from repro_torch.sched import (
        ContinuousScheduler, SchedulerConfig, poisson_trace,
    )

    pool = None
    if kw.get("kv_offload"):
        caps = ({"device_capacity": int(1.5 * row)}
                if mode.endswith("spill") else {})
        pool = default_pool(device=dev, **caps)
    # the scheduler's own spans (step phases, row park/restore, prefetch
    # issue) give where a step's host time goes
    tracer = Tracer()
    sched = ContinuousScheduler(model, params, SchedulerConfig(
        max_batch=BATCH, max_seq=MAX_SEQ, cache_dtype=torch.bfloat16, **kw),
        pool=pool, tracer=tracer)
    calls = {"decode": 0, "prefill": 0, "chunk": 0}

    def counted(name, fn, flash, ring):
        def call(*args):
            if name == "decode":
                pos = args[3]
                assert isinstance(pos, torch.Tensor) and pos.device == dev \
                    and tuple(pos.shape) == (BATCH,), pos
            f0, r0 = flash_attention_cuda.launches, decode_attention_cuda.launches
            out = fn(*args)
            got = (flash_attention_cuda.launches - f0,
                   decode_attention_cuda.launches - r0)
            assert got == (flash, ring), (mode, name, got)
            calls[name] += 1
            return out
        return call

    sched._decode = counted("decode", sched._decode, 0, n_attn)
    sched._prefill = counted("prefill", sched._prefill, n_attn, 0)
    if kw.get("chunk_size"):
        sched._chunk_prefill = counted("chunk", sched._chunk_prefill, 0, 0)
    decode_s, steps = [], []   # steps: (virtual now at start, t0, t1)
    decode_active, step = sched._decode_active, sched.step

    def timed_decode():
        t0 = time.perf_counter()
        out = decode_active()      # ends reading the step's tokens: synced
        if out:
            decode_s.append(time.perf_counter() - t0)
        return out

    def timed_step():
        now, t0 = sched.now, time.perf_counter()
        out = step()
        steps.append((now, t0, time.perf_counter()))
        return out

    sched._decode_active, sched.step = timed_decode, timed_step
    trace = poisson_trace(**trace_kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path: counts set to 0 just before, read just after
    ops.reset_launch_counts()
    out, wall = synced_s(torch, lambda: sched.run(trace))
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for name, n in counts.items():
        kernels[name]["launches"] += n
    st = dataclasses.asdict(sched.stats)
    assert calls["decode"] == len(decode_s) > 0
    assert calls["prefill"] == (0 if kw.get("chunk_size") else len(trace))
    assert calls["chunk"] == st["prefill_chunks"]
    assert counts == {"flash_attention": n_attn * calls["prefill"],
                      "paged_decode_attention": 0,
                      "decode_attention": n_attn * calls["decode"],
                      "ssd_scan": 0}, (mode, counts, calls)
    tokens = {r.seed: out[r.req_id].tolist() for r in trace}
    for r in trace:
        assert len(tokens[r.seed]) == r.max_new_tokens
        assert all(0 <= t < model.cfg.vocab_size for t in tokens[r.seed])
    # TTFT: from the start of the first step at or after the arrival to the
    # end of the step that emitted the first token
    ttft_steps, ttft_ms = [], []
    for r in trace:
        state = sched.finished[r.req_id]
        ttft_steps.append(state.t_first_token - r.arrival)
        t0 = next(t for now, t, _ in steps if now >= r.arrival)
        t1 = next(t for now, _, t in steps if now == state.t_first_token)
        ttft_ms.append((t1 - t0) * 1e3)
    snap = sched.pool_stats()
    pf = sched.prefetch_stats() or {}
    emitted = sum(len(v) for v in tokens.values())
    moved = snap["bytes_stored"] + snap["bytes_fetched"]
    log("sched", mode=mode, steps=st["steps"], tokens=emitted,
        wall_s=f"{wall:.3f}", tok_per_s=f"{emitted / wall:.1f}",
        decode_steps=len(decode_s),
        decode_ms_per_step=f"{sum(decode_s) / len(decode_s) * 1e3:.2f}",
        decode_ms_p50=f"{sorted(decode_s)[len(decode_s) // 2] * 1e3:.2f}",
        step_ms=f"{wall / st['steps'] * 1e3:.2f}",
        ttft_steps_mean=f"{sum(ttft_steps) / len(ttft_steps):.3f}",
        ttft_steps_max=f"{max(ttft_steps):.3f}",
        ttft_ms_mean=f"{sum(ttft_ms) / len(ttft_ms):.2f}",
        ttft_ms_max=f"{max(ttft_ms):.2f}")
    log("sched", mode=mode, stats=json.dumps(st),
        launches=json.dumps(counts), prefill_calls=calls["prefill"],
        chunk_calls=calls["chunk"],
        fetches_issued=pf.get("fetches_issued", 0),
        mean_plan_lead=pf.get("mean_plan_lead", "n/a"),
        plan_hw=sched.cfg.hw.name,
        waits_overlapped=snap["transfer"]["waits_overlapped"],
        waits_blocked=snap["transfer"]["waits_blocked"],
        blocked_ms=f"{snap['transfer']['blocked_s'] * 1e3:.2f}",
        pool_bytes_per_step=moved // st["steps"],
        evictions=snap["evictions"],
        host_entries_peak_bytes=snap["tier/host"]["peak"],
        max_allocated_gb=f"{peak / 1e9:.2f}")
    spans = {}
    for e in tracer.events():
        if e.cat == "sched" and e.ph == "X":
            spans[e.name] = spans.get(e.name, 0.0) + e.dur
    log("sched", mode=mode, host_ms_per_step=json.dumps(
        {k: round(v / st["steps"] * 1e3, 2) for k, v in sorted(spans.items())}))
    sched.close()
    if pool is not None:
        assert pool.snapshot()["reserved"] == 0
        pool.close()
    del sched
    torch.cuda.empty_cache()
    return {"tokens": tokens, "stats": st}


def check_sched_logits(torch, model, params, trace) -> None:
    """Each request's first-token logits. Whole prompt (B=1): flash against
    the plain path by :func:`check_logits`. Chunked (``SCHED_CHUNK``, the
    two-segment plain attention): fp32 within 1e-4 of the fp32 whole-prompt
    plain path, and bf16 no further from it than the bf16 plain path plus
    2e-2 (the maximum error)."""
    from repro_torch.models.runtime import use_attention_impl

    dev = next(_leaves(params)).device

    def first(weights, dtype, i, chunk=None):
        toks = torch.from_numpy(trace[i].tokens)[None].to(dev)
        s = toks.shape[1]
        cache = model.init_cache(1, MAX_SEQ, dtype, dev)
        with torch.inference_mode():
            if chunk is None:
                return model.prefill(weights, {"tokens": toks}, cache)[0][:, 0]
            for off in range(0, s, chunk):
                valid = min(chunk, s - off)
                t = torch.zeros(1, chunk, dtype=torch.int32, device=dev)
                t[:, :valid] = toks[:, off:off + valid]
                logits, cache = model.prefill_chunk(weights, {"tokens": t},
                                                    off, valid, cache)
            return logits[:, 0]

    check_logits(torch, "sched", lambda w, d, i: first(w, d, i), params,
                 n_prompts=len(trace))
    params32 = _tree_map(lambda t: t.float(), params)
    worst32 = 0.0
    for i in range(len(trace)):
        with use_attention_impl("plain"):
            p32 = first(params32, torch.float32, i)
            p16 = first(params, torch.bfloat16, i)
        c32 = first(params32, torch.float32, i, SCHED_CHUNK)
        c16 = first(params, torch.bfloat16, i, SCHED_CHUNK)
        err32 = (c32 - p32).abs().max().item()
        worst32 = max(worst32, err32)
        e_chunk = (c16.float() - p32).abs().max().item()
        e_plain = (p16.float() - p32).abs().max().item()
        log("sched", check="chunked first-token logits against whole-prompt "
            "fp32 plain", prompt=i, prompt_len=trace[i].prompt_len,
            fp32_max_abs_err=f"{err32:.3e}", fp32_tol=1e-4,
            bf16_chunked_max_abs_err=f"{e_chunk:.3e}",
            bf16_plain_max_abs_err=f"{e_plain:.3e}",
            tol=f"plain+2e-2={e_plain + 2e-2:.3e}",
            same_argmax=bool(c16.argmax(-1) == p16.argmax(-1)))
        assert bool(torch.isfinite(c32).all()) and bool(
            torch.isfinite(c16).all())
        assert torch.allclose(c32, p32, atol=1e-4, rtol=1e-4), (i, err32)
        assert e_chunk <= e_plain + 2e-2, (i, e_chunk, e_plain)
    del params32
    torch.cuda.empty_cache()


def check_mixed_decode_logits(torch, model, params, n_attn) -> None:
    """One decode step at the per-row positions ``SCHED_ROWS`` (a free slot
    at 0 among them), from a cache whose rows a plain prefill filled one
    request at a time, as the scheduler fills its slots: the ring kernel
    (one launch per layer) against the plain decode, by
    :func:`check_decode_logits`'s rules."""
    from repro_torch.kernels.paged_attention import decode_attention_cuda
    from repro_torch.models.runtime import use_attention_impl

    dev = next(_leaves(params)).device
    vocab = model.cfg.vocab_size
    gen = torch.Generator(device=dev).manual_seed(5)
    prompts = [torch.randint(0, vocab, (1, r), generator=gen, device=dev,
                             dtype=torch.int32) if r else None
               for r in SCHED_ROWS]
    tok = torch.randint(0, vocab, (BATCH, 1), generator=gen, device=dev,
                        dtype=torch.int32)
    pos = torch.tensor(SCHED_ROWS, dtype=torch.int32, device=dev)

    def step(weights, dtype):
        cache = model.init_cache(BATCH, MAX_SEQ, dtype, dev)
        with torch.inference_mode():
            with use_attention_impl("plain"):
                for i, p in enumerate(prompts):
                    if p is None:
                        continue
                    row = model.init_cache(1, MAX_SEQ, dtype, dev)
                    model.prefill(weights, {"tokens": p}, row)
                    for big, r in zip(_leaves(cache), _leaves(row)):
                        big[:, i] = r[:, 0]
            twin = _tree_map(lambda t: t.clone(), cache)
            before = decode_attention_cuda.launches
            kernel, _ = model.decode_step(weights, cache, tok, pos)
            torch.cuda.synchronize()
            assert decode_attention_cuda.launches == before + n_attn
            with use_attention_impl("plain"):
                plain, _ = model.decode_step(weights, twin, tok, pos)
        del cache, twin
        return kernel.float(), plain.float()

    kernel16, plain16 = step(params, torch.bfloat16)
    params32 = _tree_map(lambda t: t.float(), params)
    kernel32, plain32 = step(params32, torch.float32)
    del params32
    err32 = (kernel32 - plain32).abs().max().item()
    assert bool(torch.isfinite(kernel16).all())
    assert bool(torch.isfinite(kernel32).all())
    rms_kernel = (kernel16 - plain32).pow(2).mean().sqrt().item()
    rms_plain = (plain16 - plain32).pow(2).mean().sqrt().item()
    log("sched", check="mixed-pos decode-step logits kernel vs plain",
        pos=list(SCHED_ROWS), fp32_max_abs_err=f"{err32:.3e}", fp32_tol=1e-4,
        bf16_kernel_rms=f"{rms_kernel:.3e}", bf16_plain_rms=f"{rms_plain:.3e}",
        rms_tol=f"1.05*plain={1.05 * rms_plain:.3e}",
        bf16_kernel_vs_plain_max_abs=f"{(kernel16 - plain16).abs().max().item():.3e}")
    assert torch.allclose(kernel32, plain32, atol=1e-4, rtol=1e-4), err32
    assert rms_kernel <= 1.05 * rms_plain, (rms_kernel, rms_plain)
    del kernel16, plain16, kernel32, plain32
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 5. paged: fused decode over pool pages
# ---------------------------------------------------------------------------


def phase_paged(torch, dev, kernels) -> None:
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
    kernels["paged_decode_attention"]["launches"] += \
        counts["paged_decode_attention"]
    assert sparse.buffer_misses > 0
    assert counts["paged_decode_attention"] == 2 * PAGED_STEPS, counts
    assert counts["flash_attention"] == 0, counts
    snap = pool.snapshot()
    assert snap["bytes_stored"] > 0 and snap["bytes_fetched"] > 0
    log("paged", paged_launches=counts["paged_decode_attention"],
        pool_puts=snap["puts"], pool_gets=snap["gets"],
        host_tier=snap["tier/host"]["backend"])
    pool.close()


# ---------------------------------------------------------------------------
# 6. hybrid: zamba2-7b, resident and offload_kv; 7. ring decode on its caches
# ---------------------------------------------------------------------------


def phase_hybrid(torch, dev, kernels) -> None:
    # at 81 bf16 layers the maximum error swings with the prompt (PERF.md):
    # the bf16 rule holds the RMS error, on three prompts
    model, params, tokens = serve(torch, dev, kernels, HYBRID_ARCH, "hybrid",
                                  n_prompts=HYBRID_PROMPTS, stat="rms")
    phase_ring(torch, dev, kernels, model, params, tokens)
    del model, params, tokens
    torch.cuda.empty_cache()


def phase_ring(torch, dev, kernels, model, params, tokens) -> None:
    """After a prefill, each attention layer's plain ``attention_decode``
    (under ``use_attention_impl("plain")``) writes its ring cache and
    attends; ``ops.decode_attention`` (the ring kernel) on the cache it has
    just written, with the same query, must give the same output (after the
    layer's output projection, in bf16, 2e-2)."""
    from repro_torch.kernels import ops
    from repro_torch.models import attention as attn
    from repro_torch.models.runtime import use_attention_impl
    from repro_torch.models.transformer import _index

    cfg = model.cfg
    bf16, tol = torch.bfloat16, 2e-2
    cache = model.init_cache(BATCH, MAX_SEQ, bf16, dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    layers = [(spec, _index(seg_p, r)[f"p{i}"], _index(seg_c, r)[f"p{i}"])
              for seg, seg_p, seg_c in zip(cfg.segments, params["segments"],
                                           cache["segments"])
              for r in range(seg.repeats)
              for i, spec in enumerate(seg.pattern) if spec.mixer == "attn"]
    with torch.inference_mode():
        model.prefill(params, {"tokens": tokens}, cache)
        worst = 0.0
        ops.reset_launch_counts()
        for step in range(RING_STEPS):
            pos = PROMPT + step
            positions = attn._rope_positions(pos, BATCH, dev)
            for spec, lp, lc in layers:
                p = lp["mixer"]
                x = torch.randn(BATCH, 1, cfg.d_model, device=dev,
                                generator=gen).to(bf16)
                with use_attention_impl("plain"):
                    plain, _ = attn.attention_decode(cfg, spec, p, x, pos,
                                                     positions, lc)
                q, _, _ = attn._project_qkv(cfg, p, x, positions)
                o = ops.decode_attention(q, lc["k"], lc["v"], pos,
                                         scale=attn._scale(cfg),
                                         logit_cap=cfg.attn_logit_softcap)
                kernel = o.reshape(BATCH, 1, -1) @ p["wo"]
                torch.cuda.synchronize()
                err = (kernel.float() - plain.float()).abs().max().item()
                worst = max(worst, err)
                assert torch.allclose(kernel.float(), plain.float(), atol=tol,
                                      rtol=tol), (step, err)
        counts = ops.launch_counts()
    kernels["decode_attention"]["launches"] += counts["decode_attention"]
    assert counts["decode_attention"] == RING_STEPS * len(layers), counts
    assert counts["flash_attention"] == counts["ssd_scan"] == 0, counts
    log("ring", arch=cfg.name, attn_layers=len(layers), steps=RING_STEPS,
        cache_slots=MAX_SEQ, max_abs_err=f"{worst:.3e}", tol=tol,
        decode_attention_launches=counts["decode_attention"])


# ---------------------------------------------------------------------------
# 8. ssm: mamba2-370m forward
# ---------------------------------------------------------------------------


def phase_ssm(torch, dev, kernels) -> None:
    from repro_torch.configs import REGISTRY
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model

    cfg = REGISTRY[SSM_ARCH]
    n_attn, n_mamba = mixers(cfg)
    model = build_model(cfg)
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(4)
    params = model.init(gen, bf16, dev)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, SSM_SEQ), generator=gen,
                           device=dev, dtype=torch.int32)
    log("ssm", arch=cfg.name, layers=cfg.n_layers, mamba2_layers=n_mamba,
        d_model=cfg.d_model, ssd_heads=cfg.ssm.n_ssm_heads(cfg.d_model),
        d_state=cfg.ssm.d_state, vocab=cfg.vocab_size,
        params=sum(t.numel() for t in _leaves(params)), batch=BATCH,
        seq=SSM_SEQ)

    def forward(weights, dtype, i=0):
        del dtype, i   # the weights' type is the model's; one prompt
        with torch.inference_mode():
            return model.forward(weights, {"tokens": tokens})[0]

    # the main path: counts set to 0 just before, read just after
    ops.reset_launch_counts()
    logits, fwd_s = synced_s(torch, lambda: forward(params, bf16))
    counts = ops.launch_counts()
    kernels["ssd_scan"]["launches"] += counts["ssd_scan"]
    assert counts == {"flash_attention": 0, "paged_decode_attention": 0,
                      "decode_attention": 0, "ssd_scan": n_mamba}, counts
    assert ssd_instances() == {"mma_tf32": n_mamba, "fma_f32": 0}, \
        ssd_instances()
    assert logits.shape == (BATCH, SSM_SEQ, cfg.padded_vocab)
    assert not bool(torch.isnan(logits).any())
    del logits
    reps = 3
    _, total_s = synced_s(torch, lambda: [forward(params, bf16)
                                          for _ in range(reps)])
    check_logits(torch, "ssm", forward, params)
    log("ssm", ssd_launches=counts["ssd_scan"], ssd_instance="mma_tf32",
        first_forward_ms=f"{fwd_s * 1e3:.2f}",
        forward_ms=f"{total_s / reps * 1e3:.2f}",
        tok_per_s=f"{BATCH * SSM_SEQ * reps / total_s:.1f}")
    del params
    torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
