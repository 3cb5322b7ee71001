#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which asserts (the first failure ends the run with a
non-zero exit):

1. build   — compile the hand-written kernels (``csrc/*.cu``, one nvcc per
   source, all at once, sm_90a).
2. kernels — each kernel against its plain PyTorch version on the card:
   flash and ring decode at phi3's, zamba2's (head dim 112), gemma2's,
   granite-moe's (24 q / 8 kv heads of 64), codeqwen's (32 heads of
   128), whisper's (16 heads of 64; flash over its 64-token prompt, the
   ring over 448 slots) and qwen2-vl's (64 q / 8 kv heads of 128) shapes,
   paged decode at phi3's, gemma2's, granite's, whisper's and qwen2-vl's
   heads, in bf16
   (tolerance 2e-2)
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
   at head dim 112; flash, ring and paged decode also at granite's,
   codeqwen's, whisper's and qwen2-vl's heads, under ``"shapes"`` in the
   kernels line, the decode kernels with their split and shared memory a
   block): device time
   (launches queued behind a spin kernel, so host overhead between them is
   not counted) and time per call.
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
   Then two chunked modes. slo-overload: 16 requests, 35 % interactive
   with a 10-step TTFT deadline, at 3x the service rate, FIFO resident
   against SLO admission resident and ``kv_offload``: the two SLO runs
   agree in tokens and ``SchedStats``, preempt at least once and resume
   every preempted request, and on the virtual clock SLO's goodput and
   interactive TTFT attainment are at least FIFO's. prefix: after one warm
   request per family, 12 requests behind two 256-token system prompts
   with the prefix cache off, on (resident) and on (``kv_offload``, the
   scheduler's pool): the two on runs agree, off minus on prefill tokens
   is the hit tokens (12 hits, 3072 tokens unless a cached page was
   evicted), and one hit request's first-token logits pass the chunked
   logit rule on and off.
5. session — phase 3's phi3 weights through ``HyperOffloadSession``
   (``repro_torch.api``) on the sched phase's spill topology, telemetry
   on: ``session.scheduler`` over the sched trace with codec ``none``
   (tokens and ``SchedStats`` equal to the hand-built ``kv_offload-spill``
   run), then int8 pages below the host tier (``numel + 4`` wire bytes a
   page each way, a spilled page within ``roundtrip_bound``, the first
   decode step after a host fetch held against ``none`` by a tolerance
   derived from ``roundtrip_bound``, the share of equal tokens reported);
   ``session.overlap()`` per tier pair and ``export_trace`` through
   ``obs.check``; ``recalibrate()`` (measured rates, ``required_inflight``;
   the trace again gives the same tokens); ``session.paged_kv`` over int8
   pages (``attend_fused`` through the paged kernel against ``attend``);
   ``session.executor`` on the card (residency trace equal to
   ``core.memsim``'s); the codec's cost per page; and the launcher
   ``repro_torch.launch.serve.main`` at full width (``kv_offload``,
   ``--recalibrate``: one flash launch per layer per prefill, one ring
   launch per layer per decode step).
6. train   — phi3-mini-3.8b at full width (full depth unless the host
   cannot pin its fp32 moments) with bf16 parameters, through
   ``repro_torch.training``: four steps over the same ``SyntheticTokens``
   batches (B=2, S=512) from the same seeded parameters in each memory
   mode: ``none``, ``full`` (recompute each layer), ``offload`` (the
   tagged activations parked in pinned host memory) and ``offload`` with
   ``offload_opt_state`` (the AdamW moments in pinned host memory,
   streamed one (leaf, layer) slice at a time through the update). Per
   mode: ms per step (host clock around ``cuda.synchronize``), peak device
   memory, activation and moment bytes moved per step, losses and grad
   norms, the largest parameter and loss differences from ``none``; the
   pinned link's GB/s each way. The loss must fall in every mode, every
   mode agree with ``none`` within a bound derived from bf16 rounding,
   ``full``'s and ``offload``'s peaks lie below ``none``'s, the moments'
   offload save at least 90 % of their bytes, and ``offload`` park 3 tags ×
   layers × B × S × d_model × 2 bytes a step. Then the launcher
   ``repro_torch.launch.train.main`` at full width (``--remat offload
   --offload-opt-state``, two steps). The train step runs the plain path
   (the kernels are forward-only): no kernel may count a launch.
7. paged   — ``PagedKVCache.attend_fused`` (the paged-decode kernel over
   pool pages) against ``attend`` (the gather path) at phi3's attention
   widths, with every page selected and then top-4 of an 8-page budget.
8. hybrid  — zamba2-7b (68 Mamba2 and 13 attention layers) at full width
   and depth, as in phase 3: every prefill launches the SSD kernel once per
   Mamba2 layer (each launch the tensor-core instance) and flash once per
   attention layer, every decode step the
   ring kernel once per attention layer; the ``offload_kv`` round trip
   carries the conv, SSM-state (fp32) and K/V leaves. The prefill logits
   are checked on three prompts, the bf16 rule by RMS error.
9. ring    — ``ops.decode_attention`` (the ring-decode kernel) over the
   caches that zamba2's ``attention_decode`` on the plain path has just
   written, held against that function's output, layer by layer for a few
   steps.
10. ssm    — mamba2-370m (48 Mamba2 layers) at full width and depth:
   ``Model.forward`` at B=4, S=2048 in bf16, one SSD launch per layer (each
   the tensor-core instance), logits held against the plain path as in
   phase 3.
11. moe    — granite-moe-3b-a800m (32 layers of GQA attention and a
   40-expert top-8 MoE FFN) at full width and depth, served as in phase 3
   (flash and the ring kernel at G=3, D=64; the fp32 logit rule holds
   1e-4 while every MoE routing decision of the two paths agrees, an RMS
   of 2e-2 after a flip; the bf16 rule by RMS error); the prefill's
   dropped assignments and aux loss; the device time of the router,
   dispatch, expert products and combine of one layer; one MoE layer's
   forward and backward twice, bit for bit; the sched trace through
   ``HyperOffloadSession`` in ``continuous`` (resident) and
   ``kv_offload`` with the same tokens and ``SchedStats``; four training
   steps (B=2, S=512) in ``none`` and ``offload`` + ``offload_opt_state``
   with equal losses, grad norms and parameters.
12. mla    — minicpm3-4b (62 MLA layers, no kernel: the reference's MLA is
   plain XLA) at full width and depth, served as in phase 3 (the cache is
   the 3-D latent ``ckv``/``krope``); the device time of one layer's
   per-step latent up-projection and its share of the decode step; the
   sched trace through the session with ``kv_offload``.
13. codeqwen — codeqwen1.5-7b (dense MHA, 32 heads of 128) at full width
   and depth, served as in phase 3.
14. whisper — whisper-medium (24 encoder + 24 decoder layers, MHA 16 x 64,
   1500 frames of the audio frontend stub) at full width and depth,
   served as in phase 3 under its own traffic (a 64-token decoder prompt,
   128 greedy tokens, max_seq 448): flash on every decoder prefill, the
   ring kernel on every decode step, the encoder and cross-attention plain
   (as in the reference), the cross leaves in the ``offload_kv`` round
   trip; the encoder's time and its attention's device time; the logits
   moving with the encoder's input; the scheduler's refusal; four training
   steps (B=2, S=448) in ``none`` and ``offload`` + ``offload_opt_state``,
   bit for bit, the encoder's parameters included.
15. vlm     — qwen2-vl-72b at full width, 8 of its 80 layers (the whole
   model does not fit one card), served as in phase 3 with a 16 x 16 grid
   of vision embeddings in front of the prompt at M-RoPE positions whose
   planes differ: flash and the ring kernel at G=8, D=128; the logits
   moving with the vision embeddings and with the planes; the sched trace
   (text only) through the session in ``continuous`` and ``kv_offload``;
   four training steps at 2 layers (B=1, S=512, vision inputs) in
   ``offload`` + ``offload_opt_state``.
16. mesh   — (runs after phase 5) phase 3's phi3 weights placed as
   ``DTensor``s on a 1×1 ("data", "model") mesh on the card
   (``launch.mesh.make_debug_mesh``, ``launch.shardings``,
   ``axis_rules(DEFAULT_RULES, mesh)``), the cache too: a prefill of B=4
   × 512, 16 greedy decode steps and ``Model.loss`` at B=2 × 512 equal
   the same calls outside the rules bit for bit, with the same flash and
   ring launches in each; ms a step under the mesh beside outside it.
17. roofline — (after phase 16) ``roofline.roofline_from_trace`` over
   phi3's prefill and one decode step under ``H100``: the three terms,
   the dominant one, ``model_flops``, the useful-FLOP ratio, beside the
   calls' measured ms (a print, not a gate).
18. moe_mesh — (after phase 11) granite-moe-3b-a800m at full width:
   ``moe_ffn`` of one layer over B=4 × 512 through ``_moe_ffn_sharded``
   under the 1×1 mesh against the local path, out and aux bit for bit;
   then a full-depth prefill under the mesh, logits bit for bit.
19. dryrun — ``python -m repro_torch.launch.dryrun`` for six
   (arch × shape × mesh) combinations, one subprocess each, all at once:
   each prints ``OK``; per-device argument GB and the three terms.
20. entry  — (last) the entry points outside the package, in process,
   each given the card as its device: the continuous-serving launcher
   ``repro_torch.launch.serve_trace``
   (the counterpart of the repository root's ``launch/serve.py``) at full
   width and depth in bf16 over its own 8-request trace: phi3-mini in
   ``continuous``, ``kv_offload`` with ``--trace-out``/``--stats-json``
   (the trace through ``obs.check``, a hidden fraction, the stats' sched
   and pool sections) and ``kv_offload --slo --overload 3``, and zamba2-7b
   in ``continuous``: tokens equal to the trace's, one flash launch per
   attention layer per prompt, the ring on the decode steps, zamba2's SSD
   launches; ``repro_torch.examples``' quickstart (60 training steps with
   activation and moment offload, resident and ``kv_offload`` generations
   equal), serve_offload (``attend`` within 2e-5 of the dense oracle,
   ``attend_fused`` through the paged kernel within 2e-5 of ``attend``;
   the scheduler demo with ``slo``), train_100m at its defaults (300 steps,
   B=8, S=256: the loss falls, the resume bit for bit) and schedule_viz
   under ``H100`` (modelled, host arithmetic). The serving entry points'
   calls to the kernel wrappers are recorded, and each kernel is held
   against its plain version at every shape they called it with (zamba2's
   SSD scan at the chunk of each prompt length, 4 to 16 tokens).

Output: the card's name and power limit, one line per phase (and one with
its seconds), the total
wall time, a JSON line ``{"kernels": [...]}`` and, last, ``{"ok": true,
"device": {...}}``. The
launch counts in the kernels line are the sums over phases 3 to 18 and
20 of each phase's own count (the train phase's, the training of phases
11, 14 and 15 and train_100m's are 0; phase 17 counts nothing):
every count is set to 0 just before a phase drives the port and read just
after. Without a CUDA device, or without the port
beside this file, it prints no result and exits with 2.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
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
# the sched phase's slo-overload mode: interactive chat (35 %, a 10-step
# TTFT deadline) arriving into a batch backlog at 3x the service rate,
# 4 slots / (288 / 128 chunks + 40 decode steps) = 4 / 42.25 requests a step
SLO_TRACE = dict(n_requests=16, rate=0.284, prompt_lens=(64, 512),
                 prompt_quantum=64, new_tokens=(16, 64),
                 interactive_fraction=0.35, seed=3)
SLO_TTFT_DEADLINE = 10.0
# the sched phase's prefix mode: two families of users behind a 256-token
# system prompt, cached in 32-token pages
PREFIX_TRACE = dict(n_requests=12, rate=0.5, prompt_lens=(64, 256),
                    prompt_quantum=32, new_tokens=(16, 64),
                    n_prefix_families=2, prefix_len=256, seed=0)
PREFIX_PAGE = 32

# the train phase: phi3-mini at full width in bf16 (fp32 moments), four
# memory modes from the same initial parameters over the same batches, at
# a learning rate with which four steps visibly fit the batch they repeat
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 512, 4
TRAIN_HP = dict(peak_lr=1e-4, warmup=1)
TRAIN_MODES = (("none", False), ("full", False), ("offload", False),
               ("offload", True))
TRAIN_TAGS = 3          # resid, attn_out, mlp_out: parked per layer
TRAIN_LAUNCH_ARGV = ["--arch", ARCH, "--steps", "2", "--remat", "offload",
                     "--offload-opt-state"]

# the moe, mla and codeqwen phases: granite's MoE (40 experts, top-8),
# minicpm3's MLA and codeqwen's MHA at head dim 128, at full width and
# depth, with phase 3's traffic; granite also trains (B=2, S=512) in two
# memory modes
MOE_ARCH, MLA_ARCH, MHA_ARCH = ("granite-moe-3b-a800m", "minicpm3-4b",
                                "codeqwen1.5-7b")
MOE_TRAIN_MODES = (("none", False), ("offload", True))
# head shapes of the new paths, held in the kernels phase: (label, heads,
# kv heads, head dim)
NEW_HEADS = (("granite", 24, 8, 64), ("codeqwen", 32, 32, 128))
# the whisper and vlm phases: whisper-medium at full width and depth (24
# encoder + 24 decoder layers, MHA 16 x 64, 1500 encoder frames) under a
# 64-token decoder prompt (earlier text, as whisper's decoding conditions
# on) and 128 greedy tokens in its 448-slot decoder context; qwen2-vl-72b
# at full width (64 / 8 heads of 128, d_ff 29568, vocab 152064), 8 of its
# 80 layers (the 80 are ~145 GB in bf16), under phase 3's traffic whose
# first 256 positions are a 16 x 16 grid of vision embeddings
WHISPER_ARCH, VLM_ARCH = "whisper-medium", "qwen2-vl-72b"
WHISPER_TRAFFIC = (64, 128, 448)       # prompt, new tokens, max_seq
VLM_LAYERS, VLM_GRID = 8, 16
# training: whisper (B=2, S=448, 1500 frames) in none and offload +
# offload_opt_state; qwen2-vl at 2 layers (B=1, S=512) in offload +
# offload_opt_state only (its fp32 moments are ~34 GB of pinned host)
WHISPER_TRAIN, VLM_TRAIN = (2, 448), (1, 512)
VLM_TRAIN_LAYERS = 2
# their heads in the kernels phase: (label, heads, kv heads, head dim,
# prompt, ring slots, decode pos, per-row positions)
FRONTEND_HEADS = (("whisper", 16, 16, 64, 64, 448, 447, (191, 63, 0, 447)),
                  ("qwen2-vl", 64, 8, 128, PROMPT, MAX_SEQ, PROMPT + 8,
                   SCHED_ROWS))

# the mesh phase: phase 3's phi3 under a 1×1 mesh, 16 greedy decode steps
MESH_DECODE_STEPS = 16

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

    def run(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log("phase", name=name, seconds=f"{time.perf_counter() - t0:.2f}")
        return out

    run("build", phase_build)
    run("kernels", phase_kernels, torch, dev, kernels)
    model, params = run("serve", phase_serve, torch, dev, kernels)
    runs = run("sched", phase_sched, torch, dev, kernels, model, params)
    before = torch.cuda.memory_allocated()
    run("session", phase_session, torch, dev, kernels, model, params,
        runs["kv_offload-spill"])
    # the phase's sessions are closed and dropped (the launcher's inside
    # its main): what they handed out is freed without a collection
    torch.cuda.empty_cache()
    log("session", allocated_before_gb=f"{before / 1e9:.3f}",
        allocated_after_gb=f"{torch.cuda.memory_allocated() / 1e9:.3f}")
    del runs
    run("mesh", phase_mesh, torch, dev, kernels, model, params)
    run("roofline", phase_roofline, torch, dev, model, params)
    del model, params
    torch.cuda.empty_cache()
    run("train", phase_train, torch, dev)
    run("paged", phase_paged, torch, dev, kernels)
    run("hybrid", phase_hybrid, torch, dev, kernels)
    run("ssm", phase_ssm, torch, dev, kernels)
    run("moe", phase_moe, torch, dev, kernels)
    run("moe_mesh", phase_moe_mesh, torch, dev, kernels)
    run("mla", phase_mla, torch, dev, kernels)
    run("codeqwen", phase_codeqwen, torch, dev, kernels)
    run("whisper", phase_whisper, torch, dev, kernels)
    run("vlm", phase_vlm, torch, dev, kernels)
    run("dryrun", phase_dryrun, torch)
    run("entry", phase_entry, torch, dev, kernels)
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
    ] + [(name, 4, hq, hkv, PROMPT, d, None, None)
         for name, hq, hkv, d in NEW_HEADS] \
        + [(name, 4, hq, hkv, s, d, None, None)
           for name, hq, hkv, d, s, *_ in FRONTEND_HEADS]
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
    # times at phi3's head dim (the main shape, in the kernels line), at
    # zamba2's 112 and at the new paths' heads (granite G=3 D=64, codeqwen
    # G=1 D=128, whisper's 16 heads of 64 over its 64-token prompt,
    # qwen2-vl's G=8 D=128)
    b = 4
    for label, h, hkv, d, s in (
            ("phi3", 32, 32, 96, PROMPT), ("zamba2", 32, 32, 112, PROMPT),
            *((*head, PROMPT) for head in NEW_HEADS),
            *(head[:5] for head in FRONTEND_HEADS)):
        q = randn(b, h, s, d, dtype=torch.bfloat16)
        k, v = (randn(b, hkv, s, d, dtype=torch.bfloat16) for _ in range(2))
        scale = d ** -0.5
        instance = flash_instance(torch, flash_attention_cuda, q, k, v,
                                  dict(scale=scale))
        assert instance == "wgmma", (d, instance)
        nbytes = 2 * (q.numel() + k.numel()) * q.element_size()  # q,k,v,o
        flops = 4 * b * h * d * s * (s + 1) / 2        # causal: QK^T and PV
        bound_ms, bound_by = bound(nbytes, flops)
        ms, call_ms = timed(torch, lambda: flash_attention_cuda(q, k, v,
                                                               scale=scale))
        plain_ms, plain_call_ms = timed(
            torch, lambda: flash_attention_ref(q, k, v, scale=scale))
        # the library call on the same inputs, GQA by repeated k/v heads
        kl, vl = (t.repeat_interleave(h // hkv, dim=1) for t in (k, v))
        library_ms, _ = timed(torch, lambda: F.scaled_dot_product_attention(
            q, kl, vl, is_causal=True, scale=scale))
        del kl, vl
        if label == "phi3":
            entry.update(max_abs_err=main_err, tol=tols[torch.bfloat16],
                         ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=library_ms)
        else:
            entry.setdefault("shapes", {})[label] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)
        log("kernels", kernel="flash_attention", instance=instance,
            shape=f"{label}/B{b}xHq{h}xHkv{hkv}xS{s}xD{d}/bf16",
            ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            library_ms=f"{library_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
            bound_by=bound_by, call_ms=f"{call_ms:.4f}",
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
        ("granite", 4, 24, 8, 64, list(range(16)), 19, None),
    ] + [(name, 4, hq, hkv, d, list(range(16)), 19, None)
         for name, hq, hkv, d, *_ in FRONTEND_HEADS]
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
            if dtype == torch.bfloat16 and name in (
                    "granite", *(h[0] for h in FRONTEND_HEADS)):
                paged_time(torch, dev, entry, args, name)
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


def paged_time(torch, dev, entry, args, label) -> None:
    """Kernel and plain times of the paged kernel on ``args`` (bf16), with
    the byte bound, under ``entry["shapes"][label]``."""
    from repro_torch.kernels.paged_attention import paged_decode_attention_cuda
    from repro_torch.kernels.ref import paged_decode_attention_ref

    q, kp, vp, table, kt, vt, tail_len = args
    b, hq, d = q.shape
    hkv, tokens = kt.shape[2], table.numel() * PAGE + tail_len
    nbytes = (2 * q.numel() + 2 * b * tokens * hkv * d) * q.element_size()
    bound_ms, bound_by = bound(nbytes, 4 * b * hq * d * tokens)
    scale = d ** -0.5
    ms, _ = timed(torch, lambda: paged_decode_attention_cuda(*args,
                                                             scale=scale))
    plain_ms, _ = timed(torch, lambda: paged_decode_attention_ref(
        *args, scale=scale))
    entry.setdefault("shapes", {})[label] = dict(
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None)
    rows = (table.numel() + 1) * PAGE
    log("kernels", kernel="paged_decode_attention",
        shape=f"{label}/B{b}xHq{hq}xHkv{hkv}xD{d}/{tokens}tok/bf16",
        ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
        **split_smem(torch, dev, "paged_decode_attention_smem_bytes", b,
                     hq, hkv, d, rows))


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
    cases += [(name, 4, hq, hkv, MAX_SEQ, d, PROMPT + 8, None)
              for name, hq, hkv, d in NEW_HEADS]
    cases += [(name, 4, hq, hkv, c, d, pos, None)
              for name, hq, hkv, d, _, c, pos, _ in FRONTEND_HEADS]
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
            if dtype == torch.bfloat16 and name in {
                    n for n, *_ in NEW_HEADS + FRONTEND_HEADS}:
                decode_time(torch, entry, (q, k, v, pos), name)
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


def decode_time(torch, entry, args, label) -> None:
    """Kernel, plain and library (SDPA with the ring mask, k/v heads
    repeated for GQA) times of the ring kernel at a scalar pos, with the
    byte bound over the slots that hold a token, under
    ``entry["shapes"][label]``."""
    from repro_torch.kernels.paged_attention import decode_attention_cuda
    from repro_torch.kernels.ref import decode_attention_ref
    import torch.nn.functional as F

    q, k, v, pos = args
    b, hq, d = q.shape
    c, hkv = k.shape[1], k.shape[2]
    rows = min(pos + 1, c)
    nbytes = (2 * q.numel() + 2 * b * rows * hkv * d) * q.element_size()
    bound_ms, bound_by = bound(nbytes, 4 * b * hq * rows * d)
    scale = d ** -0.5
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    ms, _ = timed(torch, lambda: decode_attention_cuda(q, k, v, pos,
                                                       scale=scale))
    plain_ms, _ = timed(torch, lambda: decode_attention_ref(
        q, kt, vt, pos, scale=scale))
    j = torch.arange(c, device=q.device)
    mask = ((pos - torch.remainder(pos - j, c)) >= 0)[None, :]
    kl, vl = (t.repeat_interleave(hq // hkv, dim=1) for t in (kt, vt))
    library_ms, _ = timed(torch, lambda: F.scaled_dot_product_attention(
        q[:, :, None], kl, vl, attn_mask=mask, scale=scale))
    entry.setdefault("shapes", {})[label] = dict(
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=library_ms)
    log("kernels", kernel="decode_attention",
        shape=f"{label}/B{b}xHq{hq}xHkv{hkv}xC{c}xD{d}/pos{pos}/bf16",
        valid_slots=rows, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        library_ms=f"{library_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
        bound_by=bound_by,
        **split_smem(torch, q.device, "decode_attention_smem_bytes", b, hq,
                     hkv, d, c))


def split_smem(torch, dev, fn: str, b, hq, hkv, d, rows) -> dict:
    """The split-K cut the wrapper makes for this shape (rows per block,
    splits) and the shared memory a block asks for, in bf16 and fp32,
    against the card's limit (the wrapper raises above it)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import ring_split

    split = ring_split(b * hkv, rows,
                       torch.cuda.get_device_properties(dev).multi_processor_count)
    n_split = -(-rows // split)
    lib = build.load_library()
    smem = {dt: getattr(lib, fn)(code, hq // hkv, d, split, n_split)
            for dt, code in (("bf16", 1), ("fp32", 0))}
    assert max(smem.values()) <= build.MAX_SMEM_BYTES, smem
    return dict(split=split, splits=n_split, smem_bf16=smem["bf16"],
                smem_fp32=smem["fp32"], smem_limit=build.MAX_SMEM_BYTES)


def kernels_decode_rows(torch, dev, entry, randn, tols, scalar_ms) -> None:
    """The ring kernel with a device (B,) pos, each row at its own position
    (the continuous scheduler's decode): phi3's shape with rows at C - 1,
    mid-ring and a free slot decoded at 0, then with wrapped rows, and
    the new paths' heads (granite, codeqwen and qwen2-vl at the first
    rows; whisper's over its 448-slot ring); bf16 and fp32
    against the plain version at the same (B,) pos. The first case's
    device time is logged beside the scalar path's (``scalar_ms``)."""
    from repro_torch.kernels.paged_attention import decode_attention_cuda
    from repro_torch.kernels.ref import decode_attention_ref

    b = BATCH
    for name, rows, (hq, hkv, d), c in (
            ("phi3-per-row", SCHED_ROWS, (32, 32, 96), MAX_SEQ),
            ("phi3-per-row-wrapped", (600, 37, 0, 2 * MAX_SEQ - 1),
             (32, 32, 96), MAX_SEQ),
            *((f"{label}-per-row", SCHED_ROWS, (h, g, dd), MAX_SEQ)
              for label, h, g, dd in NEW_HEADS),
            *((f"{label}-per-row", rows, (h, g, dd), c)
              for label, h, g, dd, _, c, _, rows in FRONTEND_HEADS)):
        scale = d ** -0.5
        pos = torch.tensor(rows, dtype=torch.int32, device=dev)
        for dtype, tol in tols.items():
            q = randn(b, hq, d, dtype=dtype)
            k, v = randn(b, c, hkv, d, dtype=dtype), randn(b, c, hkv, d,
                                                          dtype=dtype)
            err = check(torch, f"decode/{name}{list(rows)}/"
                        f"{str(dtype)[6:]}",
                        decode_attention_cuda(q, k, v, pos, scale=scale),
                        decode_attention_ref(q, k.transpose(1, 2),
                                             v.transpose(1, 2), pos,
                                             scale=scale), tol)
            if name == "phi3-per-row" and dtype == torch.bfloat16:
                main = (q, k, v, err)
    hq, hkv, d, c = 32, 32, 96, MAX_SEQ
    scale = d ** -0.5
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
        with moe_routes() as kernel_routes:
            logits32 = run(params32, torch.float32, i)
        with use_attention_impl("plain"), moe_routes() as plain_routes:
            plain32 = run(params32, torch.float32, i)
        err32 = (logits32 - plain32).abs().max().item()
        # an MoE router picks its experts by comparing probabilities: the
        # two paths' summation orders may flip a near-tie, which changes
        # the function; 1e-4 holds while every routing decision agrees
        flips = routing_flips(kernel_routes, plain_routes)
        log(phase, check="fp32 logits kernel vs plain", prompt=i,
            max_abs_err=f"{err32:.3e}", tol=1e-4, moe_layers=len(kernel_routes),
            routing_flips=flips)
        assert bool(torch.isfinite(logits32).all())
        if flips:
            rms32 = (logits32 - plain32).pow(2).mean().sqrt().item()
            log(phase, check="fp32 logits after a routing flip", prompt=i,
                rms=f"{rms32:.3e}", rms_tol=2e-2)
            assert rms32 <= 2e-2, rms32
        else:
            assert torch.allclose(logits32, plain32, atol=1e-4,
                                  rtol=1e-4), err32
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


class _Routes(list):
    """Recorded routing calls, and their aux losses in ``aux``."""

    def __init__(self):
        super().__init__()
        self.aux = []


class moe_routes:
    """Records the decisions of every MoE router call inside the block:
    each call's expert choices and kept-assignment mask (nothing for a
    dense model)."""

    def __enter__(self):
        from repro_torch.models import moe
        self.real, self.calls = moe.route, _Routes()

        def recording(cfg, router, xf):
            r = self.real(cfg, router, xf)
            self.calls.append((r.top_e.clone(), r.keep.clone(),
                               r.dest.clone()))
            self.calls.aux.append(r.aux.clone())
            return r

        moe.route = recording
        return self.calls

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.route = self.real


def routing_flips(a, b) -> int:
    """Assignments whose expert, kept flag or buffer row differ between
    two recorded runs of the same calls."""
    assert len(a) == len(b)
    return sum(int((ea != eb).sum()) + int((ka != kb).sum())
               + int((da != db).sum())
               for (ea, ka, da), (eb, kb, db) in zip(a, b))


def check_decode_logits(torch, phase: str, model, params, batch,
                        prompt: int = PROMPT, max_seq: int = MAX_SEQ) -> None:
    """One decode step's logits with the ring kernel against the plain
    decode (``use_attention_impl("plain")``), from one cache that a plain
    prefill of ``batch`` filled, at pos = ``prompt``. fp32 (TF32 off):
    within 1e-4. bf16:
    the kernel path's RMS error against fp32 plain within 5 % of the plain
    bf16 path's (the two differ only in the decode attention, which both
    sum in fp32 and round to bf16 once). Where an MoE router's decisions
    differ between the two paths, the fp32 logits are held to an RMS of
    2e-2 and the bf16 ones by ``check_logits``'s rule (plain + 2e-2)."""
    from repro_torch.models.runtime import use_attention_impl

    dev = batch["tokens"].device

    def step(weights, dtype):
        cache = model.init_cache(BATCH, max_seq, dtype, dev)
        with torch.inference_mode():
            with use_attention_impl("plain"):
                logits, cache = model.prefill(weights, batch, cache)
            tok = logits[:, 0].argmax(-1).to(torch.int32)[:, None]
            twin = _tree_map(lambda t: t.clone(), cache)
            with moe_routes() as kernel_routes:
                kernel, _ = model.decode_step(weights, cache, tok, prompt)
            with use_attention_impl("plain"), moe_routes() as plain_routes:
                plain, _ = model.decode_step(weights, twin, tok, prompt)
        del cache, twin
        return kernel.float(), plain.float(), routing_flips(kernel_routes,
                                                            plain_routes)

    kernel16, plain16, flips16 = step(params, torch.bfloat16)
    params32 = _tree_map(lambda t: t.float(), params)
    kernel32, plain32, flips = step(params32, torch.float32)
    del params32
    err32 = (kernel32 - plain32).abs().max().item()
    assert bool(torch.isfinite(kernel16).all())
    assert bool(torch.isfinite(kernel32).all())
    rms_kernel = (kernel16 - plain32).pow(2).mean().sqrt().item()
    rms_plain = (plain16 - plain32).pow(2).mean().sqrt().item()
    log(phase, check="decode-step logits kernel vs plain", pos=prompt,
        fp32_max_abs_err=f"{err32:.3e}", fp32_tol=1e-4, routing_flips=flips,
        bf16_routing_flips=flips16,
        bf16_kernel_rms=f"{rms_kernel:.3e}", bf16_plain_rms=f"{rms_plain:.3e}",
        rms_tol=(f"plain+2e-2={rms_plain + 2e-2:.3e}" if flips16
                 else f"1.05*plain={1.05 * rms_plain:.3e}"),
        bf16_kernel_vs_plain_max_abs=f"{(kernel16 - plain16).abs().max().item():.3e}")
    if flips:   # as in check_logits
        rms32 = (kernel32 - plain32).pow(2).mean().sqrt().item()
        assert rms32 <= 2e-2, rms32
    else:
        assert torch.allclose(kernel32, plain32, atol=1e-4, rtol=1e-4), err32
    # a bf16 MoE routing flip between the two paths changes the function:
    # then the kernel path is held by check_logits's bf16 rule
    tol = rms_plain + 2e-2 if flips16 else 1.05 * rms_plain
    assert rms_kernel <= tol, (rms_kernel, rms_plain, flips16)
    del kernel16, plain16, kernel32, plain32
    torch.cuda.empty_cache()


def mixers(cfg):
    """(attention layers, Mamba2 layers) of a configuration."""
    specs = [spec for seg in cfg.segments for spec in seg.pattern
             for _ in range(seg.repeats)]
    return (sum(s.mixer == "attn" for s in specs),
            sum(s.mixer == "mamba2" for s in specs))


def serve(torch, dev, kernels, arch: str, phase: str, n_prompts: int = 1,
          stat: str = "max", metrics=None, *, cfg=None, traffic=None,
          frontend=None):
    """``ServeEngine.generate`` of ``arch`` at full width and depth in
    bf16, resident then ``offload_kv``; returns (model, params, batch),
    ``batch`` the first prompt's inputs. The prefill logits are held
    against the plain path on ``n_prompts`` prompts by ``stat`` (see
    :func:`check_logits`). ``metrics`` (a dict) receives the prefill ms,
    each mode's decode ms a step, tok/s and the round trip's bytes a step.
    ``cfg`` stands in for ``REGISTRY[arch]`` (a depth cut); ``traffic``
    (prompt, new tokens, max_seq) for phase 3's; ``frontend(gen)`` gives
    a prompt's frontend-stub entries on the card."""
    from repro_torch.configs import REGISTRY
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.models.runtime import use_attention_impl
    from repro_torch.obs import Tracer
    from repro_torch.pool import default_pool
    from repro_torch.serving import ServeEngine

    cfg = REGISTRY[arch] if cfg is None else cfg
    prompt, new_tokens, max_seq = traffic or (PROMPT, NEW_TOKENS, MAX_SEQ)
    n_attn, n_mamba = mixers(cfg)
    model = build_model(cfg)
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    params, init_s = synced_s(torch, lambda: model.init(gen, bf16, dev))
    n_params = sum(t.numel() for t in _leaves(params))
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    prompts = [dict(tokens=torch.randint(0, cfg.vocab_size, (BATCH, prompt),
                                         generator=gen, device=dev,
                                         dtype=torch.int32),
                    **(frontend(gen) if frontend else {}))
               for _ in range(n_prompts)]
    batch = prompts[0]
    log(phase, arch=cfg.name, layers=cfg.n_layers, attn_layers=n_attn,
        mamba2_layers=n_mamba, d_model=cfg.d_model, heads=cfg.n_heads,
        head_dim=cfg.head_dim, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
        params=n_params, weight_gb=f"{weight_bytes / 1e9:.2f}",
        init_s=f"{init_s:.2f}")

    def prefill(weights, dtype, i=0):
        cache = model.init_cache(BATCH, max_seq, dtype, dev)
        with torch.inference_mode():
            return model.prefill(weights, prompts[i], cache)[0]

    check_logits(torch, phase, prefill, params, n_prompts, stat)
    check_decode_logits(torch, phase, model, params, batch, prompt, max_seq)
    del prompts[1:]
    _, kernel_prefill_s = synced_s(torch, lambda: prefill(params, bf16))
    with use_attention_impl("plain"):
        _, plain_prefill_s = synced_s(torch, lambda: prefill(params, bf16))

    # the main path: counts set to 0 just before, read just after
    gb = 1e9
    ops.reset_launch_counts()
    resident = ServeEngine(model, params, max_seq=max_seq, cache_dtype=bf16)
    torch.cuda.reset_peak_memory_stats()
    res, res_s = synced_s(torch, lambda: resident.generate(batch, new_tokens))
    res_peak = torch.cuda.max_memory_allocated()
    after_resident = ops.launch_counts()
    tracer = Tracer()
    pool = default_pool(device=dev, tracer=tracer)
    offload = ServeEngine(model, params, max_seq=max_seq, cache_dtype=bf16,
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
    off, off_s = synced_s(torch, lambda: offload.generate(batch, new_tokens))
    off_peak = torch.cuda.max_memory_allocated()
    counts = ops.launch_counts()
    for name, n in counts.items():
        kernels[name]["launches"] += n

    assert res.shape == (BATCH, new_tokens) and res.dtype == torch.int32
    assert int(res.min()) >= 0 and int(res.max()) < cfg.vocab_size
    assert torch.equal(res, off), "offload_kv tokens differ from resident"
    # one prefill per generate: each attention layer launches flash once,
    # each Mamba2 layer the SSD scan once; each decode step launches the
    # ring kernel once per attention layer
    expect = {"flash_attention": n_attn, "ssd_scan": n_mamba,
              "paged_decode_attention": 0,
              "decode_attention": n_attn * (new_tokens - 1)}
    assert after_resident == expect, (after_resident, expect)
    assert counts == {k: 2 * v for k, v in expect.items()}, counts
    # every SSD launch of the bf16 prefills took the tensor-core instance
    assert ssd_instances() == {"mma_tf32": counts["ssd_scan"],
                               "fma_f32": 0}, ssd_instances()
    assert offload.stats.cache_round_trips == new_tokens - 1
    stats = offload.pool_stats()
    for key in ("puts", "gets", "bytes_stored", "bytes_fetched"):
        assert stats[key] > 0, (key, stats[key])
    trips = [e.dur for e in tracer.events() if e.name == "cache_round_trip"]
    assert len(trips) == new_tokens - 1
    # every cache leaf makes the round trip once per step, at its own dtype
    leaves = list(_leaves(model.init_cache(BATCH, max_seq, bf16, dev)))
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
    steps = new_tokens - 1
    if metrics is not None:
        metrics.update(
            prefill_ms=kernel_prefill_s * 1e3,
            resident_decode_ms=(res_s - kernel_prefill_s) / steps * 1e3,
            offload_decode_ms=(off_s - kernel_prefill_s) / steps * 1e3,
            resident_tok_per_s=BATCH * new_tokens / res_s,
            offload_tok_per_s=BATCH * new_tokens / off_s,
            round_trip_bytes=moved // len(trips), leaf_bytes=leaf_bytes,
            resident_peak_gb=res_peak / 1e9, offload_peak_gb=off_peak / 1e9)
    log(phase, mode="resident", generate_s=f"{res_s:.3f}",
        prefill_ms=f"{kernel_prefill_s * 1e3:.2f}",
        plain_prefill_ms=f"{plain_prefill_s * 1e3:.2f}",
        decode_ms_per_step=f"{(res_s - kernel_prefill_s) / steps * 1e3:.2f}",
        tok_per_s=f"{BATCH * new_tokens / res_s:.1f}")
    log(phase, mode="offload_kv", generate_s=f"{off_s:.3f}",
        decode_ms_per_step=f"{(off_s - kernel_prefill_s) / steps * 1e3:.2f}",
        tok_per_s=f"{BATCH * new_tokens / off_s:.1f}",
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
            return engine.generate(batch, PROFILE_TOKENS)
        _, wall_s = synced_s(torch, short)
        busy_ms, top = device_busy_ms(torch, short)
        if metrics is not None and busy_ms:
            metrics[f"{mode}_idle_share"] = 1 - busy_ms / (wall_s * 1e3)
        log(phase, profile=mode, new_tokens=PROFILE_TOKENS,
            wall_ms=f"{wall_s * 1e3:.2f}", device_busy_ms=f"{busy_ms:.2f}",
            device_idle_share=(f"{1 - busy_ms / (wall_s * 1e3):.3f}"
                               if busy_ms else "not measured"))
        log(phase, profile=mode, top_device_ms=json.dumps(top))
    pool.close()
    return model, params, batch


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
    runs = {}
    for mode, kw in SCHED_MODES:
        pool = None
        if kw.get("kv_offload"):
            pool = ({"device_capacity": int(1.5 * row)}
                    if mode.endswith("spill") else {})
        runs[mode] = sched_run(torch, dev, kernels, model, params, trace,
                               mode, kw, n_attn, pool=pool)

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
        assert _same_work(runs[a]["stats"]) == _same_work(runs[b]["stats"]), \
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
    sched_slo_overload(torch, dev, kernels, model, params, n_attn)
    sched_prefix(torch, dev, kernels, model, params, n_attn)
    return runs


def _same_work(stats):
    """``SchedStats`` but what differs between resident and ``kv_offload``
    by design (pages parked, cold spills)."""
    return {k: v for k, v in stats.items()
            if k not in ("pages_parked", "cold_spills")}


def _matching(a, b):
    """Tokens equal at the same index, over the requests of two runs."""
    return sum(int(x == y) for seed in a for x, y in zip(a[seed], b[seed]))


def sched_slo_overload(torch, dev, kernels, model, params, n_attn) -> None:
    """The slo-overload mode: ``SLO_TRACE`` chunked, FIFO resident against
    SLO admission resident and ``kv_offload``. Holds: the two SLO runs
    agree in tokens and ``SchedStats`` (but pages parked and cold spills);
    SLO preempts at least once and resumes every preempted request; on the
    virtual clock SLO's goodput (deadline-met tokens per step) and
    interactive TTFT attainment are at least FIFO's."""
    from repro_torch.sched import poisson_trace
    from repro_torch.slo import SLOConfig, SLOSpec, attainment_summary

    trace = poisson_trace(
        vocab_size=model.cfg.vocab_size, batch_slo=SLOSpec("batch"),
        interactive_slo=SLOSpec("interactive",
                                ttft_deadline=SLO_TTFT_DEADLINE),
        **SLO_TRACE)
    log("sched", mode="slo-overload", requests=len(trace),
        trace=json.dumps(SLO_TRACE), ttft_deadline=SLO_TTFT_DEADLINE,
        prompt_lens=[r.prompt_len for r in trace],
        new_tokens=[r.max_new_tokens for r in trace],
        arrivals=[round(r.arrival, 3) for r in trace],
        interactive=[int(r.slo.priority_class == "interactive")
                     for r in trace])
    chunked = dict(chunk_size=SCHED_CHUNK, prefill_tokens=SCHED_PREFILL_TOKENS)
    runs = {}
    for mode, slo, pool in (
            ("slo-overload-fifo", SLOConfig(), None),
            ("slo-overload-slo", SLOConfig(enable=True), None),
            ("slo-overload-slo-kv_offload", SLOConfig(enable=True), {})):
        kw = dict(chunked, slo=slo, kv_offload=pool is not None)
        run = sched_run(torch, dev, kernels, model, params, trace, mode, kw,
                        n_attn, pool=pool)
        st, served = run["stats"], run["served"]
        assert st["prefill_tokens"] == sum(r.prompt_len for r in served)
        assert st["decoded_tokens"] == sum(r.max_new_tokens - 1
                                           for r in served)
        att = attainment_summary(run["states"])
        run["goodput"] = att["met_tokens"] / max(run["now"], 1e-9)
        run["attainment"] = att["classes"]["interactive"]["ttft_attainment"]
        log("sched", mode=mode, preemptions=st["preemptions"],
            resumes=st["resumes"], shed=st["shed"],
            virtual_steps=run["now"], goodput_tokens=att["met_tokens"],
            goodput_tokens_per_step=run["goodput"],
            tokens_per_step=att["tokens"] / max(run["now"], 1e-9),
            interactive_ttft_attainment=run["attainment"],
            slo=json.dumps(run["slo"]))
        runs[mode] = run
    fifo, slo, kv = runs.values()
    assert slo["tokens"] == kv["tokens"], "SLO kv_offload tokens differ"
    assert _same_work(slo["stats"]) == _same_work(kv["stats"]), \
        (slo["stats"], kv["stats"])
    assert slo["slo"] == kv["slo"]
    assert fifo["stats"]["preemptions"] == fifo["stats"]["shed"] == 0
    assert slo["stats"]["preemptions"] >= 1
    assert slo["stats"]["resumes"] == slo["stats"]["preemptions"]
    assert slo["goodput"] >= fifo["goodput"], (slo["goodput"], fifo["goodput"])
    assert slo["attainment"] >= fifo["attainment"], \
        (slo["attainment"], fifo["attainment"])
    log("sched", check="slo-overload: SLO against FIFO (virtual clock)",
        goodput_tokens_per_step=f"{fifo['goodput']:.4f}->{slo['goodput']:.4f}",
        interactive_ttft_attainment=(f"{fifo['attainment']:.4f}->"
                                     f"{slo['attainment']:.4f}"),
        matching_tokens_slo_vs_fifo=_matching(fifo["tokens"], slo["tokens"]))


def sched_prefix(torch, dev, kernels, model, params, n_attn) -> None:
    """The prefix mode: one warm request per family (the family's prefix
    and 32 more tokens, 2 new tokens) donates the shared pages, then
    ``PREFIX_TRACE`` runs chunked with the prefix cache off, on (resident)
    and on (``kv_offload``, the cache on the scheduler's pool). Holds: the
    two on runs agree in tokens and counters; off minus on prefill tokens
    is the hit tokens; every request hits the 256 cached tokens (unless a
    cached page was evicted, which is logged with the pool's tiers); a
    cached page is 32 tokens x 32 layers x K,V x 3072 x 2 B; the first
    hit request's first-token logits pass the chunked logit rule, on and
    off. Reports the tokens that match between on and off."""
    import numpy as np

    from repro_torch.sched import Request, poisson_trace

    trace = poisson_trace(vocab_size=model.cfg.vocab_size, **PREFIX_TRACE)
    plen = PREFIX_TRACE["prefix_len"]
    families = {}
    for r in trace:
        families.setdefault(r.tokens[:plen].tobytes(), r.tokens[:plen])
    warm = [Request(tokens=np.concatenate([f, np.full(32, 1, np.int32)]),
                    max_new_tokens=2, seed=5000 + i)
            for i, f in enumerate(families.values())]
    log("sched", mode="prefix", requests=len(trace), warm=len(warm),
        trace=json.dumps(PREFIX_TRACE), page=PREFIX_PAGE,
        prompt_lens=[r.prompt_len for r in trace],
        new_tokens=[r.max_new_tokens for r in trace],
        arrivals=[round(r.arrival, 3) for r in trace])
    chunked = dict(chunk_size=SCHED_CHUNK, prefill_tokens=SCHED_PREFILL_TOKENS)
    probe = trace[0]
    runs = {}
    for mode, prefix, kv in (("prefix-off", False, False),
                             ("prefix-on", True, False),
                             ("prefix-on-kv_offload", True, True)):
        runs[mode] = sched_run(
            torch, dev, kernels, model, params, trace, mode,
            dict(chunked, kv_offload=kv), n_attn,
            pool={} if prefix else None, prefix=prefix, warm=warm,
            capture=probe.seed)
    off, on, kv = runs.values()
    assert on["tokens"] == kv["tokens"], "prefix kv_offload tokens differ"
    assert _same_work(on["stats"]) == _same_work(kv["stats"]), \
        (on["stats"], kv["stats"])
    assert on["prefix"] == kv["prefix"], (on["prefix"], kv["prefix"])
    hit = on["stats"]["prefix_hit_tokens"]
    assert off["stats"]["prefill_tokens"] - on["stats"]["prefill_tokens"] \
        == hit, (off["stats"], on["stats"])
    assert off["stats"]["prefix_hits"] == 0
    evicted = on["prefix"]["invalidations"] + on["prefix"]["evictions"]
    if evicted:
        log("sched", check="prefix: cached pages were evicted", pages=evicted,
            tiers=json.dumps(on["tiers"]))
    else:
        assert on["stats"]["prefix_hits"] == len(trace), on["stats"]
        assert hit == len(trace) * plen, on["stats"]
    cfg = model.cfg
    page_bytes = PREFIX_PAGE * n_attn * 2 * cfg.n_kv_heads * cfg.head_dim * 2
    assert on["page_bytes"] == [page_bytes], (on["page_bytes"], page_bytes)
    matching = _matching(off["tokens"], on["tokens"])
    log("sched", check="prefix: tokens, off vs on (reported)",
        matching=matching, of=sum(len(v) for v in off["tokens"].values()),
        identical_requests=sum(off["tokens"][s] == on["tokens"][s]
                               for s in off["tokens"]),
        prefill_tokens=f"{off['stats']['prefill_tokens']}->"
                       f"{on['stats']['prefill_tokens']}",
        prefix_hits=on["stats"]["prefix_hits"], prefix_hit_tokens=hit,
        cache_pages=on["prefix"]["pages"], page_bytes=page_bytes,
        cache_bytes=on["cache_bytes"])
    check_prefix_logits(torch, model, params, probe, warm, off["logits"],
                        on["logits"], kv["logits"])


def sched_run(torch, dev, kernels, model, params, trace, mode, kw, n_attn,
              *, pool=None, prefix=False, warm=(), capture=None,
              session=None, probe=None):
    """One ``ContinuousScheduler.run`` of ``trace`` in one mode; returns
    its tokens (by request seed), ``SchedStats``, the finished states, the
    requests not shed and the scheduler's SLO and prefix-cache snapshots.
    ``pool`` is None (the scheduler's own) or the capacities of a pool on
    the card; ``prefix`` adds a ``PrefixCacheManager`` on that pool, and
    ``warm`` requests run first (not counted). ``capture`` is a request
    seed whose first-token logits are kept. ``session`` builds the
    scheduler through ``HyperOffloadSession.scheduler`` (the session's
    pool, plan cache and tracer; ``kw`` are its overrides). ``probe`` (a
    dict) keeps the logits of the first decode step that reads a page
    fetched back from below the device tier, the live rows of that step
    and, with ``probe["keep_args"]``, its inputs (the batch cache
    cloned). Every entry point the scheduler calls is wrapped to count its
    kernel launches per call (no launch, no sync of its own); the step
    loop is timed on the host clock, and a prefix hit's page fetch between
    two syncs."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.paged_attention import decode_attention_cuda
    from repro_torch.obs import Tracer
    from repro_torch.pool import default_pool
    from repro_torch.prefix import PrefixCacheManager
    from repro_torch.sched import (
        DECODE, SHED, ContinuousScheduler, SchedulerConfig,
    )

    if session is not None:
        # the session's pool, prefix cache and tracer (telemetry on)
        sched = session.scheduler(model, params, **kw)
        pool, cache, tracer = session.pool, session.prefix_cache, \
            session.tracer
    else:
        if pool is not None:
            pool = default_pool(device=dev, **pool)
        cache = (PrefixCacheManager(pool, page_size=PREFIX_PAGE) if prefix
                 else None)
        # the scheduler's own spans (step phases, row park/restore,
        # prefetch issue) give where a step's host time goes
        tracer = Tracer()
        sched = ContinuousScheduler(model, params, SchedulerConfig(
            max_batch=BATCH, max_seq=MAX_SEQ, cache_dtype=torch.bfloat16,
            **kw), pool=pool, prefix_cache=cache, tracer=tracer)
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
    if probe is not None:
        park, decode = sched._park_and_issue, sched._decode

        def probed_park():
            park()
            inflight = sched._inflight.by_layer if sched._inflight else ()
            if "call" not in probe and any(
                    pool.tier_of(k) != pool.top_tier
                    for _, keys, _ in inflight for k in keys):
                probe["call"] = calls["decode"]   # the next decode reads it

        def probed_decode(*args):
            if probe.get("call") != calls["decode"] or "logits" in probe:
                return decode(*args)
            probe["rows"] = [s.slot for s in sched.slots
                             if s is not None and s.status == DECODE]
            if probe.get("keep_args"):
                probe["args"] = (_tree_map(lambda t: t.clone(), args[1]),
                                 args[2].clone(), args[3].clone())
            out = decode(*args)
            probe["logits"] = out[0][:, 0].float().clone()
            return out

        sched._park_and_issue, sched._decode = probed_park, probed_decode
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
    fetch_s, logits = [], {}
    if prefix:
        fetch = sched._fetch_prefix_pages

        def timed_fetch(pages):
            out, t = synced_s(torch, lambda: fetch(pages))
            fetch_s.append(t)
            return out

        sched._fetch_prefix_pages = timed_fetch
    if capture is not None:
        finish = sched._finish_prefill

        def captured(state, lg, row):
            if state.request.seed == capture:
                logits[capture] = lg[:, 0].float().clone()
            return finish(state, lg, row)

        sched._finish_prefill = captured
    sched.run(list(warm))
    base = dataclasses.asdict(sched.stats)
    fetch_s.clear()
    calls.update(decode=0, prefill=0, chunk=0)
    decode_s.clear()
    steps.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # a session's pool and tracer carry earlier runs: this run's counters
    # and spans are taken from here on
    snap0, t_run0 = sched.pool_stats(), tracer.now()
    # the main path: counts set to 0 just before, read just after
    ops.reset_launch_counts()
    out, wall = synced_s(torch, lambda: sched.run(trace))
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for name, n in counts.items():
        kernels[name]["launches"] += n
    st = {k: v - base[k] for k, v in dataclasses.asdict(sched.stats).items()}
    states = [sched.finished[r.req_id] for r in trace]
    served = [r for r, state in zip(trace, states) if state.status != SHED]
    assert calls["decode"] == len(decode_s) > 0
    assert calls["prefill"] == (0 if kw.get("chunk_size") else len(trace))
    assert calls["chunk"] == st["prefill_chunks"]
    assert counts == {"flash_attention": n_attn * calls["prefill"],
                      "paged_decode_attention": 0,
                      "decode_attention": n_attn * calls["decode"],
                      "ssd_scan": 0}, (mode, counts, calls)
    assert st["shed"] == len(trace) - len(served)
    tokens = {r.seed: out[r.req_id].tolist() for r in trace}
    for r in served:
        assert len(tokens[r.seed]) == r.max_new_tokens
        assert all(0 <= t < model.cfg.vocab_size for t in tokens[r.seed])
    # TTFT: from the start of the first step at or after the arrival to the
    # end of the step that emitted the first token
    ttft_steps, ttft_ms = [], []
    for r in served:
        state = sched.finished[r.req_id]
        ttft_steps.append(state.t_first_token - r.arrival)
        t0 = next(t for now, t, _ in steps if now >= r.arrival)
        t1 = next(t for now, _, t in steps if now == state.t_first_token)
        ttft_ms.append((t1 - t0) * 1e3)
    snap = sched.pool_stats()
    pf = sched.prefetch_stats() or {}
    emitted = sum(len(v) for v in tokens.values())
    moved = sum(snap[k] - snap0[k]
                for k in ("bytes_stored", "bytes_fetched"))

    def pair_bytes(sn, pair):
        return sn["transfer"]["pairs"].get(pair, {}).get("bytes", 0)

    # what crossed the host link (encoded bytes under a codec)
    wire = sum(pair_bytes(snap, p) - pair_bytes(snap0, p)
               for p in ("device->host", "host->device"))
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
        decode_graph=json.dumps({k: getattr(sched.clock, f"decode_{k}")
                                 for k in ("captures", "replays", "eager")}),
        chunk_calls=calls["chunk"],
        fetches_issued=pf.get("fetches_issued", 0),
        mean_plan_lead=pf.get("mean_plan_lead", "n/a"),
        plan_hw=sched.cfg.hw.name,
        waits_overlapped=(snap["transfer"]["waits_overlapped"]
                          - snap0["transfer"]["waits_overlapped"]),
        waits_blocked=(snap["transfer"]["waits_blocked"]
                       - snap0["transfer"]["waits_blocked"]),
        blocked_ms=f"{(snap['transfer']['blocked_s'] - snap0['transfer']['blocked_s']) * 1e3:.2f}",
        pool_bytes_per_step=moved // st["steps"],
        host_link_bytes_per_step=wire // st["steps"],
        evictions=snap["evictions"] - snap0["evictions"],
        host_entries_peak_bytes=snap["tier/host"]["peak"],
        max_allocated_gb=f"{peak / 1e9:.2f}")
    spans = {}
    for e in tracer.events():
        if e.ts < t_run0:
            continue
        if e.cat == "sched" and e.ph == "X":
            spans[e.name] = spans.get(e.name, 0.0) + e.dur
    log("sched", mode=mode, host_ms_per_step=json.dumps(
        {k: round(v / st["steps"] * 1e3, 2) for k, v in sorted(spans.items())}))
    result = {"tokens": tokens, "stats": st, "states": states,
              "served": served, "now": sched.now, "slo": sched.slo_snapshot(),
              "prefix": sched.prefix_stats(), "logits": logits}
    if prefix:
        page_bytes = {}   # cached page (index node) -> bytes
        for key, entry in pool.entries.items():
            if key.startswith(cache._ns + "/"):
                node = key.split("/", 2)[1]
                page_bytes[node] = page_bytes.get(node, 0) + entry.nbytes
        result["page_bytes"] = sorted(set(page_bytes.values()))
        result["cache_bytes"] = sum(page_bytes.values())
        result["tiers"] = {t: pool.occupancy(t)[0]
                           for t in pool.spill_order}
        log("sched", mode=mode, prefix=json.dumps(result["prefix"]),
            cache_pages=len(page_bytes), cache_bytes=result["cache_bytes"],
            page_bytes=result["page_bytes"], tiers=json.dumps(result["tiers"]),
            hit_fetches=len(fetch_s),
            hit_fetch_ms_total=f"{sum(fetch_s) * 1e3:.2f}",
            hit_fetch_ms_mean=(f"{sum(fetch_s) / len(fetch_s) * 1e3:.3f}"
                               if fetch_s else "n/a"))
    result["pool"] = snap
    sched.close()
    # the wrappers above are the scheduler's own attributes and refer back
    # to it: drop them, so the scheduler (and its caches) is freed when
    # dropped, with no reference cycle left for the collector
    for name in ("_decode", "_park_and_issue", "_prefill", "_chunk_prefill",
                 "_decode_active", "step", "_fetch_prefix_pages",
                 "_finish_prefill"):
        vars(sched).pop(name, None)
    if cache is not None and session is None:
        cache.close()
    if pool is not None:
        assert pool.snapshot()["reserved"] == 0
        if session is None:
            pool.close()
    del sched
    torch.cuda.empty_cache()
    return result


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


def check_prefix_logits(torch, model, params, probe, warm, off, on,
                        on_kv) -> None:
    """The first-token logits of one prefix-hit request by the chunked
    rule of :func:`check_sched_logits`. bf16, from the scheduler's runs:
    cache off, on and on with ``kv_offload`` each no further from the
    fp32 whole-prompt plain path than the bf16 plain path plus 2e-2. fp32:
    the hit path replayed by hand — the warm request's rows chunk-
    prefilled, its first ``prefix_len`` positions copied into a new row,
    the probe's prefill resumed there — within 1e-4 of the fp32
    whole-prompt plain path."""
    from repro_torch.models.runtime import use_attention_impl

    dev = next(_leaves(params)).device
    plen = PREFIX_TRACE["prefix_len"]
    fam = next(w for w in warm
               if bytes(w.tokens[:plen]) == bytes(probe.tokens[:plen]))

    def chunked(weights, tokens, cache, start):
        toks = torch.from_numpy(tokens)[None].to(dev)
        for off in range(start, toks.shape[1], SCHED_CHUNK):
            valid = min(SCHED_CHUNK, toks.shape[1] - off)
            t = torch.zeros(1, SCHED_CHUNK, dtype=torch.int32, device=dev)
            t[:, :valid] = toks[:, off:off + valid]
            logits, cache = model.prefill_chunk(weights, {"tokens": t}, off,
                                                valid, cache)
        return logits[:, 0], cache

    def whole(weights, dtype):
        toks = torch.from_numpy(probe.tokens)[None].to(dev)
        cache = model.init_cache(1, MAX_SEQ, dtype, dev)
        with use_attention_impl("plain"):
            return model.prefill(weights, {"tokens": toks}, cache)[0][:, 0]

    params32 = _tree_map(lambda t: t.float(), params)
    with torch.inference_mode():
        p32 = whole(params32, torch.float32)
        p16 = whole(params, torch.bfloat16)
        _, donor = chunked(params32, fam.tokens,
                           model.init_cache(1, MAX_SEQ, torch.float32, dev), 0)
        row = model.init_cache(1, MAX_SEQ, torch.float32, dev)
        for r, d in zip(_leaves(row), _leaves(donor)):
            r[:, :, :plen] = d[:, :, :plen]
        c32, _ = chunked(params32, probe.tokens, row, plen)
    del params32, donor, row
    err32 = (c32 - p32).abs().max().item()
    e_plain = (p16.float() - p32).abs().max().item()
    errs = {name: (lg[probe.seed] - p32).abs().max().item()
            for name, lg in (("off", off), ("on", on), ("on_kv", on_kv))}
    log("sched", check="prefix: hit request's first-token logits against "
        "whole-prompt fp32 plain", prompt_len=probe.prompt_len,
        hit_tokens=plen, fp32_replayed_hit_max_abs_err=f"{err32:.3e}",
        fp32_tol=1e-4, bf16_plain_max_abs_err=f"{e_plain:.3e}",
        tol=f"plain+2e-2={e_plain + 2e-2:.3e}",
        **{f"bf16_{k}_max_abs_err": f"{v:.3e}" for k, v in errs.items()},
        bf16_on_vs_off_max_abs=(
            f"{(on[probe.seed] - off[probe.seed]).abs().max().item():.3e}"))
    assert bool(torch.isfinite(c32).all())
    assert torch.allclose(c32, p32, atol=1e-4, rtol=1e-4), err32
    for name, e in errs.items():
        assert e <= e_plain + 2e-2, (name, e, e_plain)
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
# 5. session: the HyperOffloadSession front door
# ---------------------------------------------------------------------------

#: trace events a session keeps: one scheduler run's spans all fit
SESSION_RING = 1 << 18
#: the launcher's command line (phi3-mini at full width, in process)
LAUNCH_ARGV = ["--arch", ARCH, "--mode", "kv_offload", "--batch", str(BATCH),
               "--prompt-len", str(PROMPT), "--new-tokens", str(NEW_TOKENS),
               "--recalibrate", "--dtype", "bfloat16"]


def phase_session(torch, dev, kernels, model, params, spill) -> None:
    """phi3-mini through ``HyperOffloadSession`` (bf16, phase 3's weights),
    on the spill topology of the sched phase (a device tier of 1.5
    worst-case rows, then pinned host), telemetry on. ``spill`` is the
    sched phase's ``kv_offload-spill`` run, which built the same objects by
    hand. Holds, in order:

    1. ``session.scheduler`` over ``SCHED_TRACE`` with codec ``none``: the
       same tokens and ``SchedStats`` as ``spill``.
    2. The same with the int8 codec from the host tier down: every spilled
       and fetched page moves ``numel + 4`` bytes on the wire; one spilled
       page decodes within ``roundtrip_bound``; the logits of the first
       decode step that reads a page fetched back from the host tier move
       (RMS over the live rows) no further from the ``none`` run's than a
       ±``roundtrip_bound`` perturbation of every page of those rows moves
       them (seeded signs); the share of equal tokens is reported.
    3. ``session.overlap()`` per tier pair is reported, it agrees with the
       transfer counters, and ``export_trace`` passes ``obs.check``.
    4. ``session.recalibrate()``: measured device<->host rates, spec and
       ``required_inflight`` reported; the trace run again gives the same
       tokens.
    5. ``session.paged_kv`` over int8 pages: ``attend_fused`` launches the
       paged kernel, held against ``attend`` by the bf16 rule (2e-2).
    6. ``session.executor``: a planned graph on the card, its residency
       trace equal to ``core.memsim``'s, values equal to the resident
       baseline's (fp32, 1e-6).
    7. ``repro_torch.launch.serve.main`` in process (``LAUNCH_ARGV``):
       returns 0, one flash launch per layer per prefill and one ring
       launch per layer per decode step."""
    from repro_torch.api import HyperOffloadSession, OffloadConfig
    from repro_torch.api.config import KVCodecConfig, TelemetryConfig
    from repro_torch.offload import worst_case_page_bytes
    from repro_torch.sched import poisson_trace

    cfg = model.cfg
    n_attn, _ = mixers(cfg)
    trace = poisson_trace(vocab_size=cfg.vocab_size, **SCHED_TRACE)
    row = worst_case_page_bytes(model.cache_specs(1, MAX_SEQ, torch.bfloat16))
    numel = MAX_SEQ * cfg.n_kv_heads * cfg.head_dim   # one (layer, leaf) page

    def config(codec):
        return OffloadConfig(
            mode="kv_offload", max_batch=BATCH, max_seq=MAX_SEQ,
            cache_dtype="bfloat16", device_capacity=int(1.5 * row),
            kv_codec=KVCodecConfig(codec=codec),
            telemetry=TelemetryConfig(enable=True,
                                      ring_capacity=SESSION_RING))

    log("session", arch=cfg.name, row_bytes=row, page_numel=numel,
        device_tier_bytes=int(1.5 * row),
        predicted_wire_ratio=f"{(numel + 4) / (2 * numel):.6f}")
    none_probe = {"keep_args": True}
    with HyperOffloadSession(config("none"), device=dev) as sess:
        none = sched_run(torch, dev, kernels, model, params, trace,
                         "session-none", {}, n_attn, session=sess,
                         probe=none_probe)
        assert none["tokens"] == spill["tokens"], \
            "session tokens differ from the hand-built kv_offload-spill run"
        assert none["stats"] == spill["stats"], (none["stats"], spill["stats"])
        log("session", check="session == hand-built kv_offload-spill",
            tokens_equal=True, stats=json.dumps(none["stats"]))
        session_telemetry(sess, "none")
        session_executor(torch, dev, sess)
        session_recalibrate(torch, dev, kernels, model, params, trace,
                            n_attn, sess, none)

    int8_probe = {}
    with HyperOffloadSession(config("int8"), device=dev) as sess:
        host = sess.pool.tiers["host"].backend
        first = capture_first_spill(torch, host)
        q = sched_run(torch, dev, kernels, model, params, trace,
                      "session-int8", {}, n_attn, session=sess,
                      probe=int8_probe)
        check_wire_bytes(none["pool"], q["pool"], numel)
        check_spilled_page(torch, host, first)
        del host.put, first   # the wrapper refers back to the tier
        matching = _matching(none["tokens"], q["tokens"])
        total = sum(len(v) for v in none["tokens"].values())
        log("session", check="tokens, int8 vs none (reported)",
            matching=matching, of=total, share=f"{matching / total:.4f}",
            identical_requests=sum(none["tokens"][k] == q["tokens"][k]
                                   for k in none["tokens"]))
        check_codec_logits(torch, model, params, none_probe, int8_probe)
        session_telemetry(sess, "int8")
        codec_costs(torch, dev, sess)
        session_paged(torch, dev, kernels, sess)
    del none_probe, int8_probe
    torch.cuda.empty_cache()
    session_launcher(torch, dev, kernels, n_attn)


def capture_first_spill(torch, backend):
    """Wrap a codec tier's ``put`` to keep the first page encoded into it
    (a clone of the value and the handle)."""
    put, first = backend.put, {}

    def keep(value, reuse=None, timings=None):
        handle = put(value, reuse, timings)
        if "page" not in first and isinstance(value, torch.Tensor):
            first["page"], first["handle"] = value.clone(), handle
        return handle

    backend.put = keep
    return first


def check_wire_bytes(none_snap, q_snap, numel) -> None:
    """Every page the int8 tier holds moved ``numel + 4`` bytes each way;
    the device tier still stores decoded pages (2 bytes an element)."""
    wire = numel + 4
    pairs, pairs0 = q_snap["transfer"]["pairs"], none_snap["transfer"]["pairs"]
    d2h, h2d = pairs["device->host"], pairs["host->device"]
    assert d2h["bytes"] == d2h["transfers"] * wire, d2h
    assert h2d["bytes"] == h2d["transfers"] * wire, h2d
    assert q_snap["bytes_evicted"] == d2h["bytes"], q_snap
    assert q_snap["bytes_stored"] == q_snap["puts"] * 2 * numel, q_snap
    assert pairs0["device->host"]["bytes"] == \
        pairs0["device->host"]["transfers"] * 2 * numel, pairs0
    assert d2h["transfers"] == pairs0["device->host"]["transfers"], \
        (d2h, pairs0["device->host"])
    log("session", check="int8 wire bytes", page_wire_bytes=wire,
        page_decoded_bytes=2 * numel, spills=d2h["transfers"],
        fetches_from_host=h2d["transfers"],
        spill_bytes=f"{pairs0['device->host']['bytes']}->{d2h['bytes']}",
        fetch_bytes=f"{pairs0['host->device']['bytes']}->{h2d['bytes']}",
        wire_ratio=f"{d2h['bytes'] / pairs0['device->host']['bytes']:.6f}",
        host_peak_bytes=f"{none_snap['tier/host']['peak']}->"
                        f"{q_snap['tier/host']['peak']}")


def check_spilled_page(torch, backend, first) -> None:
    """The first spilled page, decoded from its pinned payload, lies within
    ``roundtrip_bound`` of the value that was put."""
    from repro_torch.pool import roundtrip_bound

    page, handle = first["page"], first["handle"]
    # the payload waits in pinned memory, the scale on the page's device
    assert handle.payload.is_pinned() and handle.scale.device == page.device
    back = backend.get(handle)
    err = (back.float() - page.float()).abs().max().item()
    bound = roundtrip_bound(backend.codec, page.float().abs().max().item())
    log("session", check="spilled page round trip", shape=list(page.shape),
        dtype=str(page.dtype).replace("torch.", ""),
        max_abs_err=f"{err:.4e}", bound=f"{bound:.4e}")
    assert back.dtype == page.dtype and back.shape == page.shape
    # the decode rounds to bf16 once more: half a bf16 ulp of the page's
    # largest element (at most absmax * 2^-8) on top of the codec's bound
    assert err <= bound + page.float().abs().max().item() * 2.0 ** -8, \
        (err, bound)


def check_codec_logits(torch, model, params, none_probe, q_probe) -> None:
    """The first decode step that reads a page fetched back from the host
    tier: its inputs differ between the ``none`` and int8 runs only by the
    codec (every earlier value is the same in both). Tolerance, from
    ``roundtrip_bound``: the RMS move of the live rows' logits when every
    page of those rows (all layers, K and V, the ``none`` run's cache)
    moves by ±roundtrip_bound with seeded signs — larger than anything the
    codec can do, which moves each element of the fetched pages by at most
    that bound."""
    from repro_torch.pool import make_codec, roundtrip_bound
    from repro_torch.serving.engine import jit_decode

    assert none_probe.get("call") is not None, "no page came back from host"
    assert q_probe.get("call") == none_probe["call"], (q_probe, none_probe)
    rows = none_probe["rows"]
    assert q_probe["rows"] == rows, (q_probe["rows"], rows)
    codec = make_codec("int8")
    cache, tok, pos = none_probe["args"]
    decode = jit_decode(model)
    gen = torch.Generator(device=tok.device).manual_seed(7)

    def perturb(leaf):
        out = leaf.clone()
        for ri in range(leaf.shape[0]):
            for slot in rows:
                page = leaf[ri, slot].float()
                bound = roundtrip_bound(codec, page.abs().max().item())
                sign = torch.randint(0, 2, page.shape, device=leaf.device,
                                     generator=gen) * 2.0 - 1.0
                out[ri, slot] = (page + sign * bound).to(leaf.dtype)
        return out

    with torch.inference_mode():
        base = decode(params, _tree_map(lambda t: t.clone(), cache), tok,
                      pos)[0][:, 0].float()
        moved = decode(params, _tree_map(perturb, cache), tok,
                       pos)[0][:, 0].float()
    ref = none_probe["logits"][rows]

    def rms(a, b):
        return (a - b).pow(2).mean().sqrt().item()

    rms_q = rms(q_probe["logits"][rows], ref)
    rms_tol = rms(moved[rows], base[rows])
    log("session", check="int8 decode logits after a host fetch",
        decode_call=none_probe["call"], rows=rows,
        rms_vs_none=f"{rms_q:.4e}", rms_tol=f"{rms_tol:.4e}",
        max_abs_vs_none=f"{(q_probe['logits'][rows] - ref).abs().max().item():.4e}",
        rerun_vs_captured_max_abs=f"{(base[rows] - ref).abs().max().item():.3e}",
        same_argmax_share=f"{(q_probe['logits'][rows].argmax(-1) == ref.argmax(-1)).float().mean().item():.4f}",
        logit_rms=f"{ref.pow(2).mean().sqrt().item():.4f}")
    assert bool(torch.isfinite(q_probe["logits"]).all())
    assert rms_q <= rms_tol, (rms_q, rms_tol)
    del base, moved, cache
    torch.cuda.empty_cache()


def session_telemetry(sess, label: str) -> None:
    """``session.overlap()`` per tier pair, its agreement with the transfer
    counters, and the exported trace through ``obs.check``."""
    import tempfile

    from repro_torch.obs import OverlapAnalyzer
    from repro_torch.obs.check import validate_file

    rep = sess.overlap()
    by_tier = {k: {"transfers": v["transfers"],
                   "hidden_s": round(v["hidden_s"], 6),
                   "exposed_s": round(v["exposed_s"], 6),
                   "hidden_fraction": (None if v["hidden_fraction"] is None
                                       else round(v["hidden_fraction"], 4))}
               for k, v in rep["by_tier"].items()}
    errs = OverlapAnalyzer.from_tracer(sess.tracer).validate(
        sess.pool.snapshot()["transfer"], clock=sess.transfer.clock())
    trace_snap = sess.tracer.snapshot()
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "session_trace.json")
        sess.export_trace(path)
        bad = validate_file(path)
        size = Path(path).stat().st_size
    log("session", codec=label, overlap=json.dumps(by_tier),
        hidden_s=f"{rep['hidden_s']:.4f}", exposed_s=f"{rep['exposed_s']:.4f}",
        hidden_fraction=rep["hidden_fraction"],
        orphan_waits=rep["orphan_waits"], trace=json.dumps(trace_snap),
        trace_file_bytes=size, check_errors=len(bad),
        counters_disagree=len(errs))
    assert bad == [], bad[:5]
    assert errs == [], errs
    assert rep["transfers"] > 0 and "host->device" in rep["by_tier"]


def session_recalibrate(torch, dev, kernels, model, params, trace, n_attn,
                        sess, before) -> None:
    """``session.recalibrate()``, then the trace again through a new
    scheduler of the session (planned under the measured spec): the same
    tokens."""
    from repro_torch.core.calibration import (
        measurements_from_pairs, required_inflight,
    )

    static = sess.hw
    workers0 = sess.transfer.workers
    cal = sess.config.calibration
    ms = measurements_from_pairs(sess.transfer.stats.snapshot()["pairs"])
    pages = max(s.prefetcher.stats.mean_fetches_per_step
                for s in sess._schedulers if s.prefetcher is not None)
    window = sess._overlap_window_s()
    need = required_inflight(ms, pages_per_step=pages, window_s=window,
                             device_tier="device", cap=cal.max_inflight,
                             min_transfers=cal.min_transfers,
                             min_bytes=cal.min_bytes)
    spec, cal_s = synced_s(torch, sess.recalibrate)
    gbps = {f"{a}->{b}": round(spec.bandwidth_between(a, b) / 1e9, 3)
            for a, b in (("device", "host"), ("host", "device"),
                         ("device", "device"))}
    log("session", check="recalibrate", static_hw=static.name,
        hw=spec.name, measured_gb_per_s=json.dumps(gbps),
        pool_bw_d2r_gbps=f"{spec.pool_bw_d2r / 1e9:.3f}",
        pool_bw_r2d_gbps=f"{spec.pool_bw_r2d / 1e9:.3f}",
        pages_per_step=f"{pages:.2f}", overlap_window_ms=f"{window * 1e3:.3f}",
        required_inflight=need, workers=f"{workers0}->{sess.transfer.workers}",
        depth=sess.transfer.depth, recalibrate_s=f"{cal_s:.3f}")
    assert spec.name == f"{static.name}+measured", spec.name
    assert sess.planner.hw is spec
    again = sched_run(torch, dev, kernels, model, params, trace,
                      "session-none-recalibrated", {}, n_attn, session=sess)
    assert again["tokens"] == before["tokens"], \
        "tokens changed after recalibration"
    assert _same_work(again["stats"]) == _same_work(before["stats"]), \
        (again["stats"], before["stats"])
    log("session", check="tokens after recalibration", equal=True,
        plan_hw=spec.name)


def codec_costs(torch, dev, sess) -> None:
    """What one page's encode and decode cost at the sched phase's page
    shape (one (layer, leaf) row: MAX_SEQ x 32 x 96, bf16): the host ms to
    issue each (no sync), its device ms (CUDA events over many calls), and
    a ``CodecBackend`` put (encode + pinned D2H, synced) and get (H2D +
    decode, synced) through the session's host tier."""
    host = sess.pool.tiers["host"].backend
    codec = host.codec
    gen = torch.Generator(device=dev).manual_seed(11)
    page = torch.randn(MAX_SEQ, 32, 96, device=dev, generator=gen).to(
        torch.bfloat16)
    q, scale = codec.encode(page)
    n = 50

    def per_call(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        host_ms = (time.perf_counter() - t0) / n * 1e3
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return host_ms, start.elapsed_time(end) / n

    enc_host, enc_dev = per_call(lambda: codec.encode(page))
    dec_host, dec_dev = per_call(lambda: codec.decode(q, scale,
                                                      torch.bfloat16))
    handle = host.put(page)
    put_s, get_s = [], []
    for _ in range(10):
        handle, t = synced_s(torch, lambda: host.put(page, handle))
        put_s.append(t)
        _, t = synced_s(torch, lambda: host.get(handle))
        get_s.append(t)
    log("session", check="codec cost per page", codec=codec.name,
        page_bytes=page.numel() * 2, wire_bytes=handle.nbytes,
        encode_host_ms=f"{enc_host:.4f}", encode_device_ms=f"{enc_dev:.4f}",
        decode_host_ms=f"{dec_host:.4f}", decode_device_ms=f"{dec_dev:.4f}",
        put_ms_synced=f"{sorted(put_s)[5] * 1e3:.4f}",
        get_ms_synced=f"{sorted(get_s)[5] * 1e3:.4f}")


def session_paged(torch, dev, kernels, sess) -> None:
    """``session.paged_kv`` (phi3's attention widths, int8 pages in the
    host tier, an 8-page device buffer): ``attend_fused`` through the paged
    kernel against ``attend`` (the gather path, plain) over the same
    quantized pages, top 8 pages, by the bf16 rule."""
    from repro_torch.kernels import ops

    b, hq, hkv, d = BATCH, 32, 32, 96
    bf16, tol, scale = torch.bfloat16, 2e-2, d ** -0.5
    gen = torch.Generator(device=dev).manual_seed(12)
    steps = 8
    total = PAGED_CONTEXT + steps
    k_seq = torch.randn(b, total, hkv, d, device=dev, generator=gen).to(bf16)
    v_seq = torch.randn(b, total, hkv, d, device=dev, generator=gen).to(bf16)
    qs = torch.randn(steps, b, hq, d, device=dev, generator=gen).to(bf16)
    ops.reset_launch_counts()
    cache = sess.paged_kv(batch=b, n_kv_heads=hkv, head_dim=d,
                          max_seq=MAX_SEQ, dtype=bf16, device_pages=8)
    cache.prefill(k_seq[:, :PAGED_CONTEXT], v_seq[:, :PAGED_CONTEXT])
    worst, fused_s = 0.0, 0.0
    for t in range(steps):
        cache.append(k_seq[:, PAGED_CONTEXT + t], v_seq[:, PAGED_CONTEXT + t])
        q = qs[t].contiguous()
        fused, dt = synced_s(torch, lambda: cache.attend_fused(
            q, scale=scale, top_k_pages=8))
        fused_s += dt
        with_counts = ops.launch_counts()
        gather = cache.attend(q, scale=scale, top_k_pages=8)
        assert ops.launch_counts() == with_counts     # the gather is plain
        err = (fused.float() - gather.float()).abs().max().item()
        worst = max(worst, err)
        assert torch.allclose(fused.float(), gather.float(), atol=tol,
                              rtol=tol), (t, err)
    counts = ops.launch_counts()
    kernels["paged_decode_attention"]["launches"] += \
        counts["paged_decode_attention"]
    assert counts["paged_decode_attention"] == steps, counts
    key = cache.k_pool[0]
    entry = sess.pool.entries[key]
    page_numel = b * cache.page_size * hkv * d
    assert entry.tier == "host" and entry.nbytes == page_numel + 4, \
        (entry.tier, entry.nbytes)
    log("session", check="paged_kv attend_fused (kernel) vs attend (gather)",
        pages=cache.full_pages, tail=cache.tail_len, steps=steps,
        max_abs_err=f"{worst:.3e}", tol=tol,
        launches=counts["paged_decode_attention"],
        page_wire_bytes=entry.nbytes, page_decoded_bytes=2 * page_numel,
        buffer_hits=cache.buffer_hits, buffer_misses=cache.buffer_misses,
        fused_ms_per_step=f"{fused_s / steps * 1e3:.3f}")


def _small_graph(ir):
    """A 4-layer chain with remote weights and an offloadable activation
    gap (``tests/conftest.py``'s ``small_graph``)."""
    g = ir.Graph()
    g.add_tensor("x", 1 << 20)
    prev = "x"
    for i in range(4):
        g.add_tensor(f"w{i}", 64 << 20, "weight", "remote")
        g.add_tensor(f"h{i}", 1 << 20)
        g.compute(f"f{i}", inputs=(prev, f"w{i}"), outputs=(f"h{i}",),
                  flops=5e11, hbm_bytes=1e6)
        prev = f"h{i}"
    g.add_tensor("skip", 128 << 20)
    g.nodes["f0"].outputs = ("h0", "skip")
    g.add_tensor("y", 1 << 20)
    g.compute("tail", inputs=("h3", "skip"), outputs=("y",),
              flops=5e11, hbm_bytes=1e6)
    return g


def session_executor(torch, dev, sess) -> None:
    """The session's planner plans a small graph; the pool executor runs
    it on the card and its residency trace equals ``core.memsim``'s. Then
    ``session.executor`` runs a planned chain of tanh(x @ w) with remote
    weights, fp32: values equal the resident baseline's within 1e-6."""
    from repro_torch.core import ir, memsim
    from repro_torch.core.torch_exec import run_baseline
    from repro_torch.pool import OffloadPlanExecutor

    plan = sess.plan(_small_graph(ir))
    predicted = memsim.simulate(plan.graph, plan.order)
    (env, trace), run_s = synced_s(
        torch, lambda: OffloadPlanExecutor(plan, sess.pool).run())
    assert env["y"].device == dev
    assert trace.matches(predicted), (trace.usage, predicted.usage)
    assert trace.prefetches > 0
    del env
    d = 256
    g = ir.Graph()
    g.add_tensor("x", d * d * 4)
    prev = "x"
    fns, inputs = {}, {}
    gen = torch.Generator(device=dev).manual_seed(13)
    for i in range(5):
        g.add_tensor(f"w{i}", 64 << 20, "weight", "remote")
        g.add_tensor(f"h{i}", d * d * 4)
        g.compute(f"f{i}", inputs=(prev, f"w{i}"), outputs=(f"h{i}",),
                  flops=1e12, hbm_bytes=1e6)
        fns[f"f{i}"] = lambda x, w: (torch.tanh(x @ w),)
        inputs[f"w{i}"] = 0.1 * torch.randn(d, d, device=dev, generator=gen)
        prev = f"h{i}"
    inputs["x"] = torch.randn(d, d, device=dev, generator=gen)
    chain = sess.plan(g)
    out = sess.executor(chain.graph, fns).run(inputs, chain.order)
    ref = run_baseline(g, fns, inputs, device=dev)
    err = (out["h4"] - ref["h4"]).abs().max().item()
    log("session", check="plan executor on the card", plan_hw=sess.hw.name,
        nodes=len(plan.order), prefetches=trace.prefetches,
        stores=trace.stores, detaches=trace.detaches,
        peak_bytes=trace.peak_bytes, residency_equals_memsim=True,
        run_s=f"{run_s:.3f}", chain_max_abs_err=f"{err:.3e}", tol=1e-6)
    assert torch.allclose(out["h4"], ref["h4"], atol=1e-6, rtol=0), err


def session_launcher(torch, dev, kernels, n_attn) -> None:
    """``python -m repro_torch.launch.serve`` in process, at phi3's full
    width (``LAUNCH_ARGV``): generate, recalibrate, generate again. One
    flash launch per layer per prefill, one ring launch per layer per
    decode step."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launcher

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path: counts set to 0 just before, read just after
    ops.reset_launch_counts()
    rc, wall = synced_s(torch, lambda: launcher.main(LAUNCH_ARGV))
    counts = ops.launch_counts()
    for name, n in counts.items():
        kernels[name]["launches"] += n
    generates = 2
    log("session", launcher=" ".join(LAUNCH_ARGV), rc=rc,
        wall_s=f"{wall:.3f}", launches=json.dumps(counts),
        max_allocated_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    assert rc == 0
    assert counts == {"flash_attention": generates * n_attn,
                      "paged_decode_attention": 0,
                      "decode_attention": generates * (NEW_TOKENS - 1)
                      * n_attn,
                      "ssd_scan": 0}, counts
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 6. train: activation offload and optimizer-state offload
# ---------------------------------------------------------------------------


def host_available_bytes() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def train_config(torch, cfg):
    """phi3 at full width; its full depth unless the host cannot pin the
    fp32 moments (with a fifth to spare for everything else), then as many
    layers as it can."""
    from repro_torch.models import transformer as tfm
    meta = tfm.init_params(cfg, None, torch.bfloat16, torch.device("meta"))
    n_layers = sum(s.repeats * len(s.pattern) for s in cfg.segments)
    total = sum(x.numel() for x in _leaves(meta))
    stacked = sum(x.numel() for x in _leaves(meta["segments"]))
    avail = host_available_bytes()
    # fp32 mu and nu: 8 bytes a parameter
    fit = int((avail / 1.25 / 8 - (total - stacked)) * n_layers // stacked)
    layers = min(n_layers, fit)
    log("train", host_available_gb=f"{avail / 1e9:.2f}",
        moments_gb_full_depth=f"{8 * total / 1e9:.2f}", layers=layers,
        cut=layers < n_layers)
    assert layers >= 4, "the host cannot pin the moments of 4 layers"
    if layers == n_layers:
        return cfg
    seg, = cfg.segments
    return dataclasses.replace(cfg, segments=(
        dataclasses.replace(seg, repeats=layers),))


def link_rates(torch, dev, nbytes: int = 1 << 30):
    """Device↔host GB/s of a pinned copy of ``nbytes``, each way alone and
    both at once (two streams), by CUDA events."""
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    host2 = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    devbuf = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    devbuf2 = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    s1, s2 = torch.cuda.Stream(dev), torch.cuda.Stream(dev)

    def timed_copy(pairs):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        ends = []
        for stream, (dst, src) in zip((s1, s2), pairs):
            stream.wait_event(start)
            with torch.cuda.stream(stream):
                dst.copy_(src, non_blocking=True)
                end = torch.cuda.Event(enable_timing=True)
                end.record(stream)
            ends.append(end)
        torch.cuda.synchronize()
        return max(start.elapsed_time(e) for e in ends) / 1e3

    h2d = nbytes / timed_copy([(devbuf, host)]) / 1e9
    d2h = nbytes / timed_copy([(host, devbuf)]) / 1e9
    both = 2 * nbytes / timed_copy([(devbuf, host), (host2, devbuf2)]) / 1e9
    return h2d, d2h, both


def train_modes(torch, dev, phase: str, cfg, modes,
                shape=(TRAIN_BATCH, TRAIN_SEQ)):
    """Four ``TRAIN_STEPS`` of ``cfg`` (bf16 parameters, fp32 moments) in
    each memory mode of ``modes`` ((remat, offload_opt_state) pairs) from
    the same seeded initialisation over the same repeated
    ``SyntheticTokens`` batch of ``shape`` (B, S), with the config's
    frontend-stub inputs. Logs per mode ms per step, peak device
    memory, activation and moment bytes a step, losses, grad norms and the
    largest differences from the first mode, then a profiled step. Holds:
    finite, falling losses; ``offload`` parking ``TRAIN_TAGS`` values a
    layer a step; the moments' bytes each way under ``offload_opt_state``;
    no kernel launch (the train step runs the plain path). Returns the
    results by mode label."""
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import tree_items
    from repro_torch.training import (
        TrainStepConfig, init_train_state, make_train_step,
    )

    model = build_model(cfg)
    layers = sum(s.repeats * len(s.pattern) for s in cfg.segments)
    # every step fits the same batch: at random initialisation the loss
    # differs more between two fresh batches than four steps of AdamW move
    # it, so only a batch seen again shows the loss fall
    bsz, seq = shape
    batch = SyntheticTokens(cfg.vocab_size, seq_len=seq, global_batch=bsz,
                            seed=0).batch(0, cfg, device=dev)
    batches = [batch] * TRAIN_STEPS
    act_per_step = TRAIN_TAGS * layers * bsz * seq * cfg.d_model * 2
    results = {}
    ref_params = None
    ops.reset_launch_counts()
    for remat, opt in modes:
        label = remat + ("+opt" if opt else "")
        ts = TrainStepConfig(remat=remat, offload_opt_state=opt, **TRAIN_HP)
        t0 = time.perf_counter()
        params, state = init_train_state(
            model, torch.Generator(device=dev).manual_seed(0),
            torch.bfloat16, ts, dev)
        step = make_train_step(model, ts)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(x.numel() for _, x in tree_items(params))
        moment_bytes = 2 * 4 * n_params
        torch.cuda.reset_peak_memory_stats()
        ms, losses, gns = [], [], []
        for b in batches:
            (params, state, m), dt = synced_s(
                torch, lambda b=b: step(params, state, b))
            ms.append(dt * 1e3)
            losses.append(float(m["loss"]))
            gns.append(float(m["grad_norm"]))
        peak = torch.cuda.max_memory_allocated()
        acts, moments = step.counts["activations"], step.counts["moments"]
        act_parked = acts.bytes_parked // TRAIN_STEPS if acts else 0
        act_fetched = acts.bytes_fetched // TRAIN_STEPS if acts else 0
        mom_parked = moments.bytes_parked // TRAIN_STEPS if moments else 0
        steady = sorted(ms[1:])[len(ms[1:]) // 2]
        fields = dict(
            mode=label, layers=layers, params=n_params,
            init_s=f"{init_s:.2f}",
            ms_per_step=json.dumps([round(x, 2) for x in ms]),
            ms_per_step_median_2_4=f"{steady:.2f}",
            peak_gb=f"{peak / 1e9:.3f}",
            act_bytes_parked_per_step=act_parked,
            act_bytes_fetched_per_step=act_fetched,
            moment_bytes_each_way_per_step=mom_parked,
            losses=json.dumps([round(x, 5) for x in losses]),
            grad_norms=json.dumps([round(x, 4) for x in gns]))
        if opt:
            fields["moment_stream_gbps"] = f"{2 * mom_parked / steady / 1e6:.2f}"
        if ref_params is None:
            ref_params = [x.to("cpu", copy=True)
                          for _, x in tree_items(params)]
            dp, first = 0.0, label
        else:
            dp = max_param_diff(torch, ref_params, params)
        if results:
            dl = max(abs(a - b) for a, b in zip(results[first]["losses"],
                                                losses))
            fields.update(max_dparam=f"{dp:.3e}", max_dloss=f"{dl:.3e}")
        log(phase, **fields)
        results[label] = dict(losses=losses, peak=peak, dp=dp,
                              act=act_parked, mom=mom_parked,
                              moment_bytes=moment_bytes, grad_norms=gns)
        assert all(map(math.isfinite, losses)), losses
        assert losses[-1] < losses[0], (label, losses)
        if remat == "offload":
            assert act_parked == act_per_step, (act_parked, act_per_step)
        if opt:
            assert mom_parked == moment_bytes, (mom_parked, moment_bytes)
        # one more step under the profiler: device busy time, idle share
        # (of a wall time the profiler itself lengthens) and top kernels
        (busy, top), wall = synced_s(torch, lambda: device_busy_ms(
            torch, lambda: step(params, state, batches[0])))
        log(phase, mode=label, profiled_step_ms=f"{wall * 1e3:.2f}",
            device_busy_ms=f"{busy:.2f}",
            idle_share=f"{max(0.0, 1 - busy / (wall * 1e3)):.3f}",
            top_kernels=json.dumps(top))
        del params, state, step
        torch.cuda.empty_cache()
    counts = ops.launch_counts()
    log(phase, launches=json.dumps(counts))
    assert not any(counts.values()), counts
    del ref_params
    return results


def phase_train(torch, dev) -> None:
    """phi3-mini at full width, bf16 parameters and fp32 moments, four
    steps in each memory mode from the same initial parameters over the
    same ``SyntheticTokens`` batches; then the training launcher. The
    train step runs the plain path (the kernels are forward-only): no
    kernel may count a launch here."""
    from repro_torch.configs import REGISTRY
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launcher

    # what the earlier phases left allocated: the sessions and schedulers
    # they dropped are freed by reference counting, with no collection
    torch.cuda.empty_cache()
    log("train", allocated_at_start_gb=f"{torch.cuda.memory_allocated() / 1e9:.3f}")
    cfg = train_config(torch, REGISTRY[ARCH])
    layers = sum(s.repeats * len(s.pattern) for s in cfg.segments)
    h2d, d2h, both = link_rates(torch, dev)
    log("train", link_h2d_gbps=f"{h2d:.2f}", link_d2h_gbps=f"{d2h:.2f}",
        link_both_ways_gbps=f"{both:.2f}")
    results = train_modes(torch, dev, "train", cfg, TRAIN_MODES)
    # agreement with none: the modes run the same arithmetic; the bound
    # allows a bf16 rounding of every parameter (2^-8 of the largest
    # magnitude, which TRAIN_HP keeps below 1) and a sign-like AdamW step
    # of +-lr taken differently at every step
    p_tol = 2.0 ** -8 + 2 * TRAIN_STEPS * TRAIN_HP["peak_lr"]
    l_tol = 2.0 ** -8 * max(results["none"]["losses"])
    for label, r in results.items():
        dl = max(abs(a - b) for a, b in zip(results["none"]["losses"],
                                            r["losses"]))
        assert r["dp"] <= p_tol and dl <= l_tol, (label, r["dp"], dl)
    none, full = results["none"], results["full"]
    off, opt = results["offload"], results["offload+opt"]
    assert full["peak"] < none["peak"] and off["peak"] < none["peak"]
    assert off["peak"] - opt["peak"] >= 0.9 * opt["moment_bytes"], \
        (off["peak"], opt["peak"], opt["moment_bytes"])
    log("train", tol_dparam=f"{p_tol:.3e}", tol_dloss=f"{l_tol:.3e}",
        moments_saved_gb=f"{(off['peak'] - opt['peak']) / 1e9:.3f}",
        moments_gb=f"{opt['moment_bytes'] / 1e9:.3f}")
    # the launcher, in process, at full width (fp32, its default)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    argv = TRAIN_LAUNCH_ARGV
    if layers < sum(s.repeats * len(s.pattern)
                    for s in REGISTRY[ARCH].segments):
        argv = argv + ["--dtype", "bfloat16"]
    rc, wall = synced_s(torch, lambda: launcher.main(argv))
    counts = ops.launch_counts()
    log("train", launcher=" ".join(argv), rc=rc, wall_s=f"{wall:.3f}",
        launches=json.dumps(counts),
        max_allocated_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    assert rc == 0 and not any(counts.values()), counts
    torch.cuda.empty_cache()


def max_param_diff(torch, ref, params) -> float:
    """Largest |Δ| between two parameter trees, one (leaf, layer) slice at
    a time on the card."""
    from repro_torch.optim.adamw import tree_items
    worst = 0.0
    for r, (_, p) in zip(ref, tree_items(params)):
        for rs, ps in zip(r.unbind(0) if r.dim() > 2 else [r],
                          p.unbind(0) if p.dim() > 2 else [p]):
            d = (rs.to(p.device).float() - ps.float()).abs().max().item()
            worst = max(worst, d)
    return worst


# ---------------------------------------------------------------------------
# 7. paged: fused decode over pool pages
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
# 8. hybrid: zamba2-7b, resident and offload_kv; 9. ring decode on its caches
# ---------------------------------------------------------------------------


def phase_hybrid(torch, dev, kernels) -> None:
    # at 81 bf16 layers the maximum error swings with the prompt (PERF.md):
    # the bf16 rule holds the RMS error, on three prompts
    model, params, batch = serve(torch, dev, kernels, HYBRID_ARCH, "hybrid",
                                 n_prompts=HYBRID_PROMPTS, stat="rms")
    phase_ring(torch, dev, kernels, model, params, batch["tokens"])
    del model, params, batch
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
# 10. ssm: mamba2-370m forward
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


# ---------------------------------------------------------------------------
# 11. moe: granite-moe-3b-a800m; 12. mla: minicpm3-4b; 13. codeqwen1.5-7b
# ---------------------------------------------------------------------------


def phase_moe(torch, dev, kernels) -> None:
    """granite-moe-3b-a800m (32 layers of GQA attention, G=3, D=64, and a
    40-expert top-8 MoE FFN) at full width and depth: served as in phase 3
    (the fp32 logit rule counts MoE routing flips; the bf16 rule holds the
    RMS error), its routing (dropped assignments, aux loss), the device
    time of the MoE pieces, two runs of one MoE layer bit for bit, the sched
    trace through ``HyperOffloadSession`` resident and ``kv_offload``, then
    training in ``none`` and ``offload`` + ``offload_opt_state`` with equal
    losses and parameters."""
    from repro_torch.configs import REGISTRY

    model, params, batch = serve(torch, dev, kernels, MOE_ARCH, "moe",
                                 stat="rms")
    moe_routing(torch, model, params, batch["tokens"])
    moe_costs(torch, dev, model, params)
    moe_determinism(torch, dev, model, params)
    sched_session(torch, dev, kernels, model, params, "moe",
                  ("continuous", "kv_offload"))
    del model, params, batch
    torch.cuda.empty_cache()
    results = train_modes(torch, dev, "moe", REGISTRY[MOE_ARCH],
                          MOE_TRAIN_MODES)
    none, off = results["none"], results["offload+opt"]
    log("moe", check="training, offload+opt vs none",
        losses_equal=off["losses"] == none["losses"],
        grad_norms_equal=off["grad_norms"] == none["grad_norms"],
        max_dparam=off["dp"],
        peak_saved_gb=f"{(none['peak'] - off['peak']) / 1e9:.3f}")
    assert off["losses"] == none["losses"], (off["losses"], none["losses"])
    assert off["grad_norms"] == none["grad_norms"] and off["dp"] == 0.0


def moe_routing(torch, model, params, tokens) -> None:
    """One bf16 prefill of the serve traffic: each layer's dropped
    assignments (beyond an expert's capacity) and the summed aux loss."""
    from repro_torch.models import moe

    cfg = model.cfg
    with torch.inference_mode(), moe_routes() as routes:
        cache = model.init_cache(BATCH, MAX_SEQ, torch.bfloat16, tokens.device)
        model.prefill(params, {"tokens": tokens}, cache)
        del cache
    n = BATCH * PROMPT
    dropped = [int((~keep).sum()) for _, keep, _ in routes]
    aux = sum(float(a) for a in routes.aux)
    assert len(dropped) == cfg.n_layers and math.isfinite(aux)
    log("moe", prefill_tokens=n, experts=cfg.moe.n_experts,
        top_k=cfg.moe.top_k, capacity=moe.expert_capacity(n, cfg),
        capacity_factor=cfg.moe.capacity_factor,
        dropped_assignments=sum(dropped),
        of=n * cfg.moe.top_k * cfg.n_layers,
        dropped_share=f"{sum(dropped) / (n * cfg.moe.top_k * cfg.n_layers):.5f}",
        dropped_per_layer=json.dumps(dropped), aux_loss=f"{aux:.6f}")


def moe_costs(torch, dev, model, params) -> None:
    """Device ms of the MoE pieces of one layer at the prefill's and a
    decode step's token counts (bf16), and per step (times the layers):
    the router (logits, top-k, the dispatch's indices), the dispatch
    gather, the expert products, the combine, and the whole FFN."""
    from repro_torch.models import moe
    from repro_torch.models.transformer import _index

    cfg = model.cfg
    p = _index(params["segments"][0], 0)["p0"]["ffn"]
    e, d = cfg.moe.n_experts, cfg.d_model
    gen = torch.Generator(device=dev).manual_seed(5)
    for label, n in (("prefill", BATCH * PROMPT), ("decode", BATCH)):
        x = torch.randn(n, d, device=dev, generator=gen).to(torch.bfloat16)
        with torch.inference_mode():
            r = moe.route(cfg, p["router"], x)
            ein = moe._Dispatch.apply(x, r.row_token, r.token_dest) \
                .reshape(e, r.capacity, d)

            def experts():
                h = torch.nn.functional.silu(torch.bmm(ein, p["w_gate"])) \
                    * torch.bmm(ein, p["w_up"])
                return torch.bmm(h, p["w_down"])

            eflat = torch.cat([experts().reshape(e * r.capacity, d),
                               x.new_zeros((1, d))])
            w = r.token_w.to(eflat.dtype)
            pieces = {
                "router": lambda: moe.route(cfg, p["router"], x),
                "dispatch": lambda: moe._Dispatch.apply(x, r.row_token,
                                                        r.token_dest),
                "experts": experts,
                "combine": lambda: moe._gather_rows_summed(
                    eflat, r.token_dest, w),
                "ffn": lambda: moe.moe_ffn(cfg, p, x[None]),
            }
            # a few calls each: every piece launches tens of kernels, and
            # the queue behind the spin kernel holds about a thousand
            ms = {k: timed(torch, fn, iters=4)[0]
                  for k, fn in pieces.items()}
        log("moe", costs=label, tokens=n, capacity=r.capacity,
            device_ms_per_layer=json.dumps({k: round(v, 4)
                                            for k, v in ms.items()}),
            device_ms_per_step=json.dumps({k: round(v * cfg.n_layers, 3)
                                           for k, v in ms.items()}))


def moe_determinism(torch, dev, model, params) -> None:
    """One MoE layer's forward and backward at the training shape (B=2,
    S=512, bf16), twice: outputs, aux loss and every gradient equal bit for
    bit (the dispatch and the combine are gathers summed in a fixed
    order)."""
    from repro_torch.models import moe
    from repro_torch.models.transformer import _index

    cfg = model.cfg
    gen = torch.Generator(device=dev).manual_seed(6)
    p0 = _index(params["segments"][0], 0)["p0"]["ffn"]
    x0 = torch.randn(TRAIN_BATCH, TRAIN_SEQ, cfg.d_model, device=dev,
                     generator=gen).to(torch.bfloat16)
    wt = torch.randn(x0.shape, device=dev, generator=gen)
    runs = []
    for _ in range(2):
        p = {k: v.detach().clone().requires_grad_(True) for k, v in p0.items()}
        x = x0.clone().requires_grad_(True)
        out, aux = moe.moe_ffn(cfg, p, x)
        ((out.float() * wt).sum() + aux).backward()
        runs.append([out.detach(), aux.detach(), x.grad,
                     *(p[k].grad for k in sorted(p))])
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    log("moe", check="one MoE layer's forward and backward twice",
        tokens=TRAIN_BATCH * TRAIN_SEQ, bitwise_equal=same)
    assert same


def sched_session(torch, dev, kernels, model, params, phase, modes) -> None:
    """The sched phase's trace through ``HyperOffloadSession.scheduler`` in
    each session mode of ``modes`` (``continuous``: resident,
    ``kv_offload``: pages through the pool), telemetry on. Holds what
    ``sched_run`` holds, prefill and decoded tokens equal to the trace's,
    and, between two modes, the same tokens and ``SchedStats`` but pages
    parked."""
    from repro_torch.api import HyperOffloadSession, OffloadConfig
    from repro_torch.api.config import TelemetryConfig
    from repro_torch.sched import poisson_trace

    cfg = model.cfg
    n_attn, _ = mixers(cfg)
    trace = poisson_trace(vocab_size=cfg.vocab_size, **SCHED_TRACE)
    runs = {}
    for mode in modes:
        conf = OffloadConfig(mode=mode, max_batch=BATCH, max_seq=MAX_SEQ,
                             cache_dtype="bfloat16",
                             telemetry=TelemetryConfig(
                                 enable=True, ring_capacity=SESSION_RING))
        with HyperOffloadSession(conf, device=dev) as sess:
            runs[mode] = run = sched_run(
                torch, dev, kernels, model, params, trace,
                f"{phase}-session-{mode}", {}, n_attn, session=sess)
        st = run["stats"]
        assert st["prefill_tokens"] == sum(r.prompt_len for r in trace)
        assert st["decoded_tokens"] == sum(r.max_new_tokens - 1
                                           for r in trace)
        assert (st["pages_parked"] > 0) == (mode == "kv_offload"), st
    if len(runs) == 2:
        a, b = runs.values()
        assert a["tokens"] == b["tokens"], f"{phase}: tokens differ"
        assert _same_work(a["stats"]) == _same_work(b["stats"])
    log(phase, check="sched trace through the session", modes=list(modes),
        tokens_equal=True, first_tokens=runs[modes[0]]["tokens"][0][:8])


def phase_mla(torch, dev, kernels) -> None:
    """minicpm3-4b (62 MLA layers) at full width and depth, served as in
    phase 3 (MLA runs no kernel: plain PyTorch on every device), the share
    of a decode step that the latent up-projection takes, and the sched
    trace through the session with ``kv_offload`` (the 3-D latent leaves
    parked and fetched through the pool)."""
    metrics = {}
    model, params, _ = serve(torch, dev, kernels, MLA_ARCH, "mla",
                             metrics=metrics)
    mla_upprojection(torch, dev, model, params, metrics)
    sched_session(torch, dev, kernels, model, params, "mla", ("kv_offload",))
    del model, params
    torch.cuda.empty_cache()


def mla_upprojection(torch, dev, model, params, metrics) -> None:
    """Device ms of one layer's per-step up-projection of the whole latent
    ring (``ckv @ wukv``, (B, C, r) x (r, H (dn + dv)), bf16) and its share
    of the resident decode step."""
    from repro_torch.models import attention as attn
    from repro_torch.models.transformer import _index

    cfg = model.cfg
    p = _index(params["segments"][0], 0)["p0"]["mixer"]
    gen = torch.Generator(device=dev).manual_seed(7)
    ckv = torch.randn(BATCH, MAX_SEQ, cfg.mla.kv_lora_rank, device=dev,
                      generator=gen).to(torch.bfloat16)
    with torch.inference_mode():
        ms, _ = timed(torch, lambda: attn._mla_expand(cfg, p, ckv))
    step_ms = ms * cfg.n_layers
    m = cfg.mla
    log("mla", upprojection=f"B{BATCH}xC{MAX_SEQ}xr{m.kv_lora_rank}"
        f"->H{cfg.n_heads}x{m.qk_nope_head_dim + m.v_head_dim}",
        device_ms_per_layer=f"{ms:.4f}", device_ms_per_step=f"{step_ms:.3f}",
        resident_decode_ms_per_step=f"{metrics['resident_decode_ms']:.2f}",
        share_of_decode_step=f"{step_ms / metrics['resident_decode_ms']:.4f}")


def phase_codeqwen(torch, dev, kernels) -> None:
    """codeqwen1.5-7b (dense MHA, 32 heads of 128) at full width and depth,
    served as in phase 3: flash at D=128, G=1 on every prefill, the ring
    kernel on every decode step."""
    serve(torch, dev, kernels, MHA_ARCH, "codeqwen")
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 14. whisper: whisper-medium; 15. vlm: qwen2-vl-72b at 8 of 80 layers
# ---------------------------------------------------------------------------


def depth(cfg, layers: int):
    """``cfg`` with its one segment cut to ``layers`` repeats."""
    seg, = cfg.segments
    return dataclasses.replace(cfg, segments=(
        dataclasses.replace(seg, repeats=layers),))


def phase_whisper(torch, dev, kernels) -> None:
    """whisper-medium at full width and depth (24 encoder and 24 decoder
    layers, MHA 16 x 64, 1500 frames): served as in phase 3 under its own
    traffic (B=4, a 64-token decoder prompt, 128 greedy tokens, max_seq
    448; flash at 16 heads of 64 on the decoder's prefill, the ring kernel
    over its 448 slots; the encoder's self-attention and every
    cross-attention plain, as in the reference), the round trip carrying
    the cross leaves; the encoder's time; the logits moving with the
    encoder's input; the continuous scheduler refusing it; then four
    training steps (B=2, S=448) in ``none`` and ``offload`` +
    ``offload_opt_state``, losses, grad norms and every parameter (the
    encoder's too) equal bit for bit."""
    from repro_torch.configs import REGISTRY

    cfg = REGISTRY[WHISPER_ARCH]

    def frontend(gen):
        # fp32, as the reference's frontend makes them: the encoder runs
        # in fp32 over the bf16 weights, as the reference promotes
        return {"enc_embeds": 0.1 * torch.randn(
            BATCH, cfg.encoder.n_frames, cfg.d_model, device=dev,
            generator=gen)}

    metrics = {}
    model, params, batch = serve(torch, dev, kernels, WHISPER_ARCH,
                                 "whisper", metrics=metrics,
                                 traffic=WHISPER_TRAFFIC, frontend=frontend)
    whisper_encoder(torch, dev, model, params, batch, metrics, frontend)
    del model, params, batch
    torch.cuda.empty_cache()
    results = train_modes(torch, dev, "whisper", cfg, MOE_TRAIN_MODES,
                          shape=WHISPER_TRAIN)
    none, off = results["none"], results["offload+opt"]
    log("whisper", check="training, offload+opt vs none (encoder included)",
        losses_equal=off["losses"] == none["losses"],
        grad_norms_equal=off["grad_norms"] == none["grad_norms"],
        max_dparam=off["dp"],
        peak_saved_gb=f"{(none['peak'] - off['peak']) / 1e9:.3f}")
    assert off["losses"] == none["losses"], (off["losses"], none["losses"])
    assert off["grad_norms"] == none["grad_norms"] and off["dp"] == 0.0


def whisper_encoder(torch, dev, model, params, batch, metrics,
                    frontend) -> None:
    """The encoder's share of the prefill (host clock, and the device time
    the profiler records), one encoder layer's plain self-attention over
    the 1500 frames (device ms behind the spin kernel, times the layers),
    the prefill logits against those of another encoder input (they must
    move), the cross leaves' bytes in the round trip, and the scheduler's
    refusal."""
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as tfm
    from repro_torch.sched import ContinuousScheduler, SchedulerConfig

    cfg = model.cfg
    emb = batch["enc_embeds"]
    n = cfg.encoder.n_layers
    with torch.inference_mode():
        walls = [synced_s(torch, lambda: tfm.encode(cfg, params, emb))[1]
                 for _ in range(3)]
        busy_ms, top = device_busy_ms(
            torch, lambda: tfm.encode(cfg, params, emb))
        p = tfm._index(params["encoder"]["layers"], 0)["mixer"]
        pos = torch.arange(emb.shape[1], device=dev)[None].expand(BATCH, -1)
        attn_ms, _ = timed(torch, lambda: attn.attention_full(
            cfg, tfm.ENCODER_LAYER, p, emb, pos, causal=False), iters=4)

        def logits(b):
            cache = model.init_cache(BATCH, WHISPER_TRAFFIC[2],
                                     torch.bfloat16, dev)
            return model.prefill(params, b, cache)[0].float()

        base = logits(batch)
        other = logits(dict(batch, **frontend(
            torch.Generator(device=dev).manual_seed(11))))
    moved = (base - other).abs().max().item()
    enc_ms = sorted(walls)[1] * 1e3
    log("whisper", encoder_ms=f"{enc_ms:.2f}",
        encoder_device_busy_ms=f"{busy_ms:.2f}",
        prefill_ms=f"{metrics['prefill_ms']:.2f}",
        encoder_share_of_prefill=f"{enc_ms / metrics['prefill_ms']:.3f}",
        encoder_attention_device_ms_per_layer=f"{attn_ms:.4f}",
        encoder_attention_device_ms=f"{attn_ms * n:.3f}",
        encoder_top_kernels=json.dumps(top))
    log("whisper", check="prefill logits move with the encoder's input",
        max_abs_change=f"{moved:.3e}", min_change=1e-2)
    assert math.isfinite(moved) and moved > 1e-2, moved
    # the cross leaves' share of the round trip: (xk, xv) of every layer
    cross = 2 * cfg.n_layers * BATCH * cfg.encoder.n_frames \
        * cfg.n_kv_heads * cfg.head_dim * 2
    log("whisper", resident_decode_ms=f"{metrics['resident_decode_ms']:.2f}",
        offload_decode_ms=f"{metrics['offload_decode_ms']:.2f}",
        resident_tok_per_s=f"{metrics['resident_tok_per_s']:.1f}",
        offload_tok_per_s=f"{metrics['offload_tok_per_s']:.1f}",
        resident_peak_gb=f"{metrics['resident_peak_gb']:.3f}",
        offload_peak_gb=f"{metrics['offload_peak_gb']:.3f}",
        resident_idle_share=f"{metrics.get('resident_idle_share', float('nan')):.3f}",
        round_trip_bytes_per_step=metrics["round_trip_bytes"],
        cache_bytes=metrics["leaf_bytes"], cross_leaf_bytes=cross,
        self_leaf_bytes=metrics["leaf_bytes"] - cross)
    try:
        ContinuousScheduler(model, params, SchedulerConfig(
            max_batch=BATCH, max_seq=WHISPER_TRAFFIC[2]))
    except ValueError as e:
        log("whisper", scheduler="refused", reason=json.dumps(str(e)))
    else:
        raise AssertionError("the scheduler took an encoder model")


def vision_frontend(torch, dev, cfg, b: int, s: int, grid: int):
    """Frontend-stub inputs of a prompt whose first grid x grid positions
    are vision embeddings (0.1 x N(0, 1), bf16) at M-RoPE positions whose
    planes differ (temporal 0, height the row, width the column); text
    positions are the sequence index in all three planes, as decode
    continues them."""
    n = grid * grid

    def make(gen):
        emb = torch.zeros(b, s, cfg.d_model, device=dev, dtype=torch.bfloat16)
        emb[:, :n] = 0.1 * torch.randn(b, n, cfg.d_model, device=dev,
                                       generator=gen)
        mask = torch.zeros(b, s, dtype=torch.bool, device=dev)
        mask[:, :n] = True
        pos = torch.arange(s, dtype=torch.int32, device=dev).expand(
            3, b, s).clone()
        span = torch.arange(n, dtype=torch.int32, device=dev)
        pos[0, :, :n] = 0
        pos[1, :, :n] = span // grid
        pos[2, :, :n] = span % grid
        return {"vision_embeds": emb, "vision_mask": mask, "positions": pos}
    return make


def phase_vlm(torch, dev, kernels) -> None:
    """qwen2-vl-72b at full width, cut to ``VLM_LAYERS`` of its 80 layers:
    served as in phase 3 (flash at 64 / 8 heads of 128, G=8, and the ring
    kernel at the same heads) with a 16 x 16 vision grid in front of the
    prompt; the prefill logits moving with the vision embeddings and with
    the grid's planes; the sched trace (text only) through
    ``HyperOffloadSession`` in ``continuous`` and ``kv_offload``; then four
    training steps at ``VLM_TRAIN_LAYERS`` layers (B=1, S=512, vision
    inputs) in ``offload`` + ``offload_opt_state``, if the host can pin the
    moments."""
    from repro_torch.configs import REGISTRY
    from repro_torch.models import transformer as tfm

    full = REGISTRY[VLM_ARCH]
    cfg = depth(full, VLM_LAYERS)
    frontend = vision_frontend(torch, dev, cfg, BATCH, PROMPT, VLM_GRID)
    model, params, batch = serve(torch, dev, kernels, VLM_ARCH, "vlm",
                                 cfg=cfg, frontend=frontend)
    with torch.inference_mode():
        def logits(b):
            cache = model.init_cache(BATCH, MAX_SEQ, torch.bfloat16, dev)
            return model.prefill(params, b, cache)[0].float()

        base = logits(batch)
        other_embeds = frontend(torch.Generator(device=dev).manual_seed(12))
        equal_planes = torch.arange(PROMPT, dtype=torch.int32,
                                    device=dev).expand(3, BATCH, PROMPT)
        moved = {
            "vision_embeds": logits(dict(
                batch, vision_embeds=other_embeds["vision_embeds"])),
            "equal_planes": logits(dict(batch, positions=equal_planes))}
    moved = {k: (base - v).abs().max().item() for k, v in moved.items()}
    log("vlm", check="prefill logits move with the vision embeds and with "
        "the grid's M-RoPE planes",
        **{k: f"{v:.3e}" for k, v in moved.items()}, min_change=1e-2)
    assert all(math.isfinite(v) and v > 1e-2 for v in moved.values()), moved
    del base, other_embeds
    sched_session(torch, dev, kernels, model, params, "vlm",
                  ("continuous", "kv_offload"))
    del model, params, batch
    torch.cuda.empty_cache()
    train_cfg = depth(full, VLM_TRAIN_LAYERS)
    meta = tfm.init_params(train_cfg, None, torch.bfloat16,
                           torch.device("meta"))
    n_params = sum(x.numel() for x in _leaves(meta))
    need, avail = 1.25 * 8 * n_params, host_available_bytes()
    log("vlm", train_layers=VLM_TRAIN_LAYERS, train_params=n_params,
        moments_gb=f"{8 * n_params / 1e9:.2f}",
        host_available_gb=f"{avail / 1e9:.2f}", can_pin=avail >= need)
    if avail < need:
        log("vlm", train="left out: the host cannot pin the moments")
        return
    train_modes(torch, dev, "vlm", train_cfg, (("offload", True),),
                shape=VLM_TRAIN)


# ---------------------------------------------------------------------------
# 16. mesh, 17. roofline, 18. moe_mesh, 19. dryrun
# ---------------------------------------------------------------------------

#: the dry-run's combinations: (arch, shape, multi-pod)
DRYRUN_COMBOS = (("mamba2-370m", "decode_32k", False),
                 ("phi3-mini-3.8b", "train_4k", False),
                 ("granite-moe-3b-a800m", "train_4k", False),
                 ("gemma2-9b", "prefill_32k", False),
                 ("qwen2-vl-72b", "decode_32k", False),
                 ("phi3-mini-3.8b", "train_4k", True))
DRYRUN_TIMEOUT = 300


def _local(t):
    """A DTensor's whole value (a plain tensor as it is)."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def phase_mesh(torch, dev, kernels, model, params) -> None:
    """phi3-mini at full width and depth (phase 3's weights) on a 1×1
    ("data", "model") mesh on the card: the weights placed as ``DTensor``s
    by ``launch.shardings`` under ``axis_rules(DEFAULT_RULES, mesh)``, the
    cache too. A prefill of B=4 × 512 and 16 greedy decode steps, and
    ``Model.loss`` at B=2, S=512: logits, tokens and loss equal the same
    calls outside the rules bit for bit, and each run launches flash once
    per layer per prefill and the ring kernel once per layer per decode
    step, under the mesh as outside it. ms a step under the mesh beside
    outside it: the ``DTensor`` dispatch is host work."""
    from contextlib import nullcontext

    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import close_mesh, make_debug_mesh
    from repro_torch.launch.shardings import (cache_shardings,
                                              param_shardings, place)
    from repro_torch.sharding.rules import DEFAULT_RULES, axis_rules

    cfg = model.cfg
    n_attn, _ = mixers(cfg)
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(21)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen,
                           device=dev, dtype=torch.int32)
    tb, ts = TRAIN_BATCH, TRAIN_SEQ
    train = {"tokens": torch.randint(0, cfg.vocab_size, (tb, ts),
                                     generator=gen, device=dev,
                                     dtype=torch.int32)}
    train["targets"] = torch.roll(train["tokens"], -1, dims=1)
    steps = MESH_DECODE_STEPS
    mesh = make_debug_mesh((1, 1))
    rules = dict(DEFAULT_RULES)
    try:
        placed = place(params, param_shardings(params, mesh, rules), mesh)
        log("mesh", mesh=str(tuple(mesh.shape)), device=mesh.device_type,
            placed_leaves=len(list(_leaves(placed))),
            wq_placements=str(placed["segments"][0]["p0"]["mixer"][
                "wq"].placements))

        def decode(weights, under):
            cache = model.init_cache(BATCH, PROMPT + steps, bf16, dev)
            if under:
                cache = place(cache, cache_shardings(cache, mesh, rules),
                              mesh)
            ctx = axis_rules(rules, mesh) if under else nullcontext()
            with torch.no_grad(), ctx:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lg, _ = model.prefill(weights, {"tokens": tokens}, cache)
                logits = [_local(lg)]
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                for i in range(steps):
                    nxt = logits[-1][:, -1].argmax(-1).to(torch.int32)[:, None]
                    lg, _ = model.decode_step(weights, cache, nxt, PROMPT + i)
                    logits.append(_local(lg))
                torch.cuda.synchronize()
                t2 = time.perf_counter()
            return logits, (t1 - t0) * 1e3, (t2 - t1) / steps * 1e3

        def loss(weights, under):
            ctx = axis_rules(rules, mesh) if under else nullcontext()
            with torch.no_grad(), ctx:
                out = _local(model.loss(weights, train))
                torch.cuda.synchronize()
            return out

        ops.reset_launch_counts()
        want, _, _ = decode(params, False)
        want_loss = loss(params, False)
        plain_counts = ops.launch_counts()
        ops.reset_launch_counts()
        got, _, _ = decode(placed, True)
        got_loss = loss(placed, True)
        mesh_counts = ops.launch_counts()
        for name, n in mesh_counts.items():
            kernels[name]["launches"] += n
        expect = {"flash_attention": 2 * n_attn, "ssd_scan": 0,
                  "paged_decode_attention": 0,
                  "decode_attention": n_attn * steps}
        log("mesh", plain_launches=json.dumps(plain_counts),
            mesh_launches=json.dumps(mesh_counts))
        assert plain_counts == expect, (plain_counts, expect)
        assert mesh_counts == plain_counts, (mesh_counts, plain_counts)
        same = [bool(torch.equal(a, b)) for a, b in zip(got, want)]
        toks_w = torch.cat([l[:, -1].argmax(-1)[:, None] for l in want], 1)
        toks_g = torch.cat([l[:, -1].argmax(-1)[:, None] for l in got], 1)
        log("mesh", check="under the mesh vs outside, bit for bit",
            logits_equal=f"{sum(same)}/{len(same)}",
            tokens_equal=bool(torch.equal(toks_g, toks_w)),
            loss=f"{want_loss.item():.6f}",
            loss_equal=bool(torch.equal(got_loss, want_loss)),
            first_tokens=toks_w[0, :8].tolist())
        assert all(same) and torch.equal(toks_g, toks_w)
        assert torch.equal(got_loss, want_loss)
        assert bool(torch.isfinite(want_loss)) and want_loss.item() > 0
        # ms a step: the second run of each, warm
        _, pre_plain, dec_plain = decode(params, False)
        _, pre_mesh, dec_mesh = decode(placed, True)
        log("mesh", prefill_ms=f"{pre_plain:.2f}",
            mesh_prefill_ms=f"{pre_mesh:.2f}",
            decode_ms_per_step=f"{dec_plain:.2f}",
            mesh_decode_ms_per_step=f"{dec_mesh:.2f}",
            dtensor_overhead_ms_per_step=f"{dec_mesh - dec_plain:.2f}",
            dtensor_overhead_ms_prefill=f"{pre_mesh - pre_plain:.2f}")
        del placed, want, got
    finally:
        close_mesh()
    torch.cuda.empty_cache()


def phase_roofline(torch, dev, model, params) -> None:
    """The counterpart of ``roofline_from_compiled``
    (``roofline.roofline_from_trace``) over phi3's full-width prefill
    (B=4, 512) and one decode step on the card, under ``H100``: compute,
    memory and collective seconds, the dominant term, ``model_flops`` and
    the useful-FLOP ratio; beside them the same calls' measured ms (host
    clock around a synchronize) as a share of the largest term. A print,
    not a gate. The flash and ring kernels' own work lies outside the
    dispatcher, so the trace's terms leave it out: it is counted here from
    the shapes, as the kernels phase counts each kernel's bound (flash
    reads q, k, v and writes o, causal; the ring kernel reads q and the
    slots that hold a token and writes o), and the share is taken of the
    roofline with it."""
    from repro_torch.core.costmodel import H100
    from repro_torch.roofline import roofline_from_trace

    cfg = model.cfg
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(22)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen,
                           device=dev, dtype=torch.int32)
    cache = model.init_cache(BATCH, MAX_SEQ, bf16, dev)
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    cache_bytes = sum(t.numel() * t.element_size() for t in _leaves(cache))
    nxt = torch.zeros((BATCH, 1), dtype=torch.int32, device=dev)
    n_attn, _ = mixers(cfg)
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rows = min(PROMPT + 1, MAX_SEQ)
    elt = torch.finfo(bf16).bits // 8
    kernel_work = {      # (bytes, flops) of the kernels' launches
        "prefill": (n_attn * 2 * BATCH * PROMPT * (hq + hkv) * d * elt,
                    n_attn * 4 * BATCH * hq * d * PROMPT * (PROMPT + 1) / 2),
        "decode": (n_attn * (2 * BATCH * hq * d + 2 * BATCH * rows * hkv * d)
                   * elt, n_attn * 4 * BATCH * hq * rows * d)}
    calls = {
        "prefill": (lambda: model.prefill(params, {"tokens": tokens}, cache),
                    BATCH * PROMPT),
        "decode": (lambda: model.decode_step(params, cache, nxt, PROMPT),
                   BATCH)}
    with torch.inference_mode():
        for name, (fn, n_tok) in calls.items():
            _, terms = roofline_from_trace(
                fn, cfg=cfg, tokens=n_tok, train=False, hw=H100,
                arg_bytes=weight_bytes + cache_bytes)
            fn()
            walls = [synced_s(torch, fn)[1] * 1e3 for _ in range(3)]
            ms = sorted(walls)[1]
            k_bytes, k_flops = kernel_work[name]
            compute_s = (terms.flops + k_flops) / H100.flops
            memory_s = (terms.hbm_bytes + k_bytes) / H100.hbm_bw
            top = max(compute_s, memory_s, terms.collective_s) * 1e3
            r = terms.row()
            log("roofline", call=name, tokens=n_tok,
                compute_s=f"{r['compute_s']:.6e}",
                memory_s=f"{r['memory_s']:.6e}",
                collective_s=f"{r['collective_s']:.6e}",
                dominant=r["dominant"], flops=f"{r['flops']:.4e}",
                hbm_bytes=f"{r['hbm_bytes']:.4e}",
                model_flops=f"{r['model_flops']:.4e}",
                useful_flops_ratio=f"{r['useful_flops_ratio']:.4f}",
                peak_bytes_per_device=f"{r['peak_bytes_per_device']:.4e}",
                kernel_bytes=f"{k_bytes:.4e}", kernel_flops=f"{k_flops:.4e}",
                with_kernels_compute_s=f"{compute_s:.6e}",
                with_kernels_memory_s=f"{memory_s:.6e}",
                measured_ms=f"{ms:.3f}", roofline_ms=f"{top:.3f}",
                roofline_over_measured=f"{top / ms:.3f}")
            assert terms.flops > 0 and terms.hbm_bytes > 0
            assert terms.coll_bytes == 0      # one device: no collective
    del cache
    torch.cuda.empty_cache()


def phase_moe_mesh(torch, dev, kernels) -> None:
    """granite-moe-3b-a800m at full width (40 experts, top-8, d_model 1536)
    under the 1×1 mesh: ``moe_ffn`` on one layer's weights and a B=4 × 512
    activation through ``_moe_ffn_sharded`` against the local path (out
    and aux bit for bit), then one full-depth prefill under the mesh
    against outside it (logits bit for bit, tokens equal, flash once per
    layer in each)."""
    from repro_torch.configs import REGISTRY
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import close_mesh, make_debug_mesh
    from repro_torch.launch.shardings import (cache_shardings,
                                              param_shardings, place)
    from repro_torch.models import moe
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import _index
    from repro_torch.sharding.rules import DEFAULT_RULES, axis_rules

    cfg = REGISTRY[MOE_ARCH]
    n_attn, _ = mixers(cfg)
    bf16 = torch.bfloat16
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(23)
    params = model.init(gen, bf16, dev)
    x = torch.randn(BATCH, PROMPT, cfg.d_model, generator=gen, device=dev
                    ).to(bf16)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen,
                           device=dev, dtype=torch.int32)
    mesh = make_debug_mesh((1, 1))
    rules = dict(DEFAULT_RULES)
    sharded = []
    real = moe._moe_ffn_sharded

    def counting(*args, **kwargs):
        sharded.append(1)
        return real(*args, **kwargs)
    try:
        placed = place(params, param_shardings(params, mesh, rules), mesh)
        layer = _index(params["segments"][0], 0)["p0"]["ffn"]
        placed_layer = _index(placed["segments"][0], 0)["p0"]["ffn"]
        with torch.no_grad():
            want_out, want_aux = moe.moe_ffn(cfg, layer, x)
            moe._moe_ffn_sharded = counting
            with axis_rules(rules, mesh):
                out, aux = moe.moe_ffn(cfg, placed_layer, x)
            out, aux = _local(out), _local(aux)
        log("moe_mesh", check="moe_ffn under the mesh vs local, one layer",
            tokens=BATCH * PROMPT, experts=cfg.moe.n_experts,
            top_k=cfg.moe.top_k, sharded_calls=len(sharded),
            out_equal=bool(torch.equal(out, want_out)),
            aux_equal=bool(torch.equal(aux, want_aux)),
            aux=f"{want_aux.item():.6f}")
        assert len(sharded) == 1
        assert torch.equal(out, want_out) and torch.equal(aux, want_aux)

        def prefill(weights, under):
            cache = model.init_cache(BATCH, MAX_SEQ, bf16, dev)
            if under:
                cache = place(cache, cache_shardings(cache, mesh, rules),
                              mesh)
            ops.reset_launch_counts()
            with torch.no_grad():
                if under:
                    with axis_rules(rules, mesh):
                        lg = _local(model.prefill(weights, {"tokens": tokens},
                                                  cache)[0])
                else:
                    lg = model.prefill(weights, {"tokens": tokens}, cache)[0]
            torch.cuda.synchronize()
            return lg, ops.launch_counts()

        want, plain_counts = prefill(params, False)
        del sharded[:]
        got, mesh_counts = prefill(placed, True)
        for name, n in mesh_counts.items():
            kernels[name]["launches"] += n
        log("moe_mesh", check="full-depth prefill under the mesh",
            layers=cfg.n_layers, sharded_calls=len(sharded),
            logits_equal=bool(torch.equal(got, want)),
            tokens_equal=bool(torch.equal(got.argmax(-1), want.argmax(-1))),
            plain_launches=json.dumps(plain_counts),
            mesh_launches=json.dumps(mesh_counts))
        assert len(sharded) == cfg.n_layers
        assert torch.equal(got, want)
        assert plain_counts == mesh_counts
        assert mesh_counts["flash_attention"] == n_attn
    finally:
        moe._moe_ffn_sharded = real
        close_mesh()
    del model, params
    torch.cuda.empty_cache()


def phase_dryrun(torch) -> None:
    """``python -m repro_torch.launch.dryrun`` for each of
    ``DRYRUN_COMBOS``, one subprocess each, all started together (the fake
    process group must not live in this process; the CPU holds the fake
    tensors, no card is used). Every combination must print ``OK``; logs
    its per-device argument GB, the three roofline terms and the trace's
    seconds."""
    import os
    import tempfile

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for i, (arch, shape, mp) in enumerate(DRYRUN_COMBOS):
            out = Path(tmp) / f"{i}.json"
            argv = [sys.executable, "-m", "repro_torch.launch.dryrun",
                    "--arch", arch, "--shape", shape, "--out", str(out)]
            argv += ["--multi-pod"] if mp else []
            procs.append((arch, shape, mp, out, subprocess.Popen(
                argv, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)))
        failed = []
        for arch, shape, mp, out, proc in procs:
            try:
                stdout, stderr = proc.communicate(timeout=DRYRUN_TIMEOUT)
            except subprocess.TimeoutExpired:
                for *_, p in procs:
                    p.kill()
                    p.communicate()
                raise
            mesh = "2x16x16" if mp else "16x16"
            ok = proc.returncode == 0 and "OK " in stdout
            if not ok:
                failed.append((arch, shape, mesh))
                print(stdout[-2000:], stderr[-4000:], flush=True)
                continue
            rec, = json.loads(out.read_text())
            r = rec["roofline"]
            log("dryrun", arch=arch, shape=shape, mesh=mesh,
                argument_gb_per_device=f"{rec['memory_analysis']['argument_gb']:.4f}",
                compute_s=f"{r['compute_s']:.6e}",
                memory_s=f"{r['memory_s']:.6e}",
                collective_s=f"{r['collective_s']:.6e}",
                dominant=r["dominant"],
                useful_flops_ratio=f"{r['useful_flops_ratio']:.4f}",
                collectives=json.dumps(rec["collectives"]),
                trace_s=rec["trace_s"], place_s=rec["place_s"])
    assert not failed, f"dry-run combinations failed: {failed}"


# ---------------------------------------------------------------------------
# 20. entry: the entry points outside the package
# ---------------------------------------------------------------------------

#: the continuous-serving launcher's runs (``repro_torch.launch.serve_trace``,
#: the counterpart of the repository root's ``launch/serve.py``): its own
#: trace (8 requests, prompts 4-16, 2-12 new tokens, 3 slots, max_seq 48)
#: at full width and depth in bf16; ``{tmp}`` is a temporary directory
ENTRY_LAUNCHES = (
    ("phi3-continuous", ["--arch", ARCH, "--mode", "continuous"]),
    ("phi3-kv_offload-traced", ["--arch", ARCH, "--mode", "kv_offload",
                                "--trace-out", "{tmp}/trace.json",
                                "--stats-json", "{tmp}/stats.json"]),
    ("phi3-kv_offload-slo", ["--arch", ARCH, "--mode", "kv_offload",
                             "--slo", "--overload", "3"]),
    ("zamba2-continuous", ["--arch", HYBRID_ARCH, "--mode", "continuous"]),
)
ENTRY_LAUNCH_FLAGS = ["--dtype", "bfloat16"]
#: train_100m's flags: its defaults (300 steps, B=8, S=256) and a
#: temporary --ckpt-dir
ENTRY_TRAIN_ARGV: list = []
ENTRY_PAGED_TOL = 2e-5      # fp32, TF32 off


def phase_entry(torch, dev, kernels) -> None:
    """The port's entry points outside the package, in process, each with
    ``--device``/``device=`` naming the card: the launcher
    ``repro_torch.launch.serve_trace`` (``ENTRY_LAUNCHES``), then
    ``repro_torch.examples``' quickstart, serve_offload (the paged demo,
    then ``--continuous --slo``), train_100m and schedule_viz. Each entry
    point's launches are counted from 0 just before it and read just
    after. The model's calls to the kernel wrappers in the serving entry
    points are recorded (``kernel_calls``), and each kernel is then held
    against its plain version at every signature they recorded."""
    calls: set = set()
    with kernel_calls(calls):
        entry_launcher(torch, dev, kernels)
        entry_quickstart(torch, dev, kernels)
        entry_serve_offload(torch, dev, kernels)
    entry_kernels(torch, dev, calls)
    entry_train_100m(torch, dev, kernels)
    entry_schedule_viz()


@contextlib.contextmanager
def kernel_calls(calls: set):
    """Record the signature of every call made to the kernel wrappers of
    ``repro_torch.kernels.ops`` while inside (shapes, types and options;
    no tensor is kept), then put the wrappers back. The model looks the
    wrappers up at each call, so the recorded calls are the main path's
    own, and they launch the kernels as before."""
    from repro_torch.kernels import ops

    names = ("flash_attention", "decode_attention", "ssd_scan")
    saved = {name: getattr(ops, name) for name in names}

    def flash_attention(q, k, v, **kw):
        calls.add(("flash", tuple(q.shape), tuple(k.shape), q.dtype,
                   tuple(sorted(kw.items()))))
        return saved["flash_attention"](q, k, v, **kw)

    def decode_attention(q, k, v, pos, **kw):
        rows = pos.dtype if getattr(pos, "dim", lambda: 0)() == 1 else None
        calls.add(("decode", tuple(q.shape), tuple(k.shape), k.dtype, rows,
                   tuple(sorted(kw.items()))))
        return saved["decode_attention"](q, k, v, pos, **kw)

    def ssd_scan(x, a, b_mat, c_mat, chunk):
        calls.add(("ssd", tuple(x.shape), tuple(b_mat.shape), b_mat.dtype,
                   b_mat.stride(2) == 0, chunk))
        return saved["ssd_scan"](x, a, b_mat, c_mat, chunk)

    for name, fn in zip(names, (flash_attention, decode_attention, ssd_scan)):
        setattr(ops, name, fn)
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def entry_kernels(torch, dev, calls: set) -> None:
    """Each kernel held against its plain version at every signature the
    serving entry points called it with (``kernel_calls``): the same
    shapes, types and options on inputs drawn from a seeded generator
    (bf16 2e-2, fp32 2e-5, the SSD scan at ``SSD_ATOL``/``SSD_RTOL`` as in
    the kernels phase). The launcher's prompts are 4, 8, 12 or 16 tokens
    (more after a preemption), so zamba2's SSD scan runs one chunk of
    each such length, most of them a partial 16-row tile; the ring decode
    runs at per-row device positions, the fp32 examples' at a scalar.
    These launches count on no path (each entry point's counts were read
    before)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import (
        decode_attention_ref, flash_attention_ref, ssd_scan_ref,
    )

    gen = torch.Generator(device=dev).manual_seed(22)
    tols = {torch.bfloat16: 2e-2, torch.float32: 2e-5}

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, device=dev, generator=gen).to(dtype)

    def name(kind, *dims):
        return f"entry/{kind}/" + "x".join(
            str(d).removeprefix("torch.") for d in dims)

    kinds = {kind: sorted((c for c in calls if c[0] == kind), key=str)
             for kind in ("flash", "decode", "ssd")}
    assert all(kinds.values()), {k: len(v) for k, v in kinds.items()}
    for _, q_shape, k_shape, dtype, kw in kinds["flash"]:
        kw = dict(kw)
        q = randn(*q_shape, dtype=dtype)
        k, v = (randn(*k_shape, dtype=dtype) for _ in range(2))
        ref = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), **kw).transpose(1, 2)
        check(torch, name("flash", *q_shape, k_shape[2], dtype),
              ops.flash_attention(q, k, v, **kw), ref, tols[dtype])
    for _, q_shape, k_shape, dtype, rows, kw in kinds["decode"]:
        b, c = k_shape[:2]
        q = randn(*q_shape, dtype=dtype)
        k, v = (randn(*k_shape, dtype=dtype) for _ in range(2))
        if rows is None:
            pos = int(torch.randint(c, (1,), device=dev, generator=gen))
        else:
            pos = torch.randint(c, (b,), device=dev, generator=gen).to(rows)
        ref = decode_attention_ref(q[:, 0], k.transpose(1, 2),
                                   v.transpose(1, 2), pos, **dict(kw))
        check(torch, name("decode", *k_shape, dtype,
                          "rows" if rows is not None else "scalar"),
              ops.decode_attention(q, k, v, pos, **dict(kw))[:, 0], ref,
              tols[dtype])
    for _, x_shape, bc_shape, dtype, shared, chunk in kinds["ssd"]:
        b, s, h, p = x_shape
        x, a = randn(*x_shape), -randn(b, s, h).abs() * 0.1
        bm, cm = ((randn(b, s, 1, bc_shape[3]) * 0.3).to(dtype)
                  .expand(*bc_shape) if shared else
                  (randn(*bc_shape) * 0.3).to(dtype) for _ in range(2))
        y, state = ops.ssd_scan(x, a, bm, cm, chunk)
        y_ref, state_ref = ssd_scan_ref(x, a, bm, cm, chunk)
        for what, out, ref in (("y", y, y_ref), ("state", state, state_ref)):
            check(torch, name("ssd", *x_shape, bc_shape[3], dtype,
                              f"chunk{chunk}", what),
                  out, ref, SSD_ATOL, rtol=SSD_RTOL)
    log("entry", check="kernels at the entry points' own signatures",
        signatures=json.dumps({k: len(v) for k, v in kinds.items()}),
        flash_lengths=sorted({c[1][1] for c in kinds["flash"]}),
        ssd_chunks=sorted({c[5] for c in kinds["ssd"]}),
        decode_rows=sorted({c[2][0] for c in kinds["decode"]}))


def _entry_counts(kernels, counts) -> dict:
    for name, n in counts.items():
        kernels[name]["launches"] += n
    return counts


def entry_launcher(torch, dev, kernels) -> None:
    """``serve_trace.run`` for each of ``ENTRY_LAUNCHES``: the tokens equal
    the trace's requested tokens; one flash launch per attention layer per
    admitted prompt, the ring kernel on the decode steps and (zamba2) one
    SSD launch per Mamba2 layer per prompt; the traced run's file passes
    ``obs.check`` and its overlap has a hidden fraction; the stats JSON
    holds ``sched`` and ``pool``. Logs steps, wall s, ms a step, the SLO
    run's goodput and attainment, peak device GB."""
    import tempfile

    from repro_torch.kernels import ops
    from repro_torch.launch import serve_trace
    from repro_torch.obs.check import validate_file

    for label, argv in ENTRY_LAUNCHES:
        with tempfile.TemporaryDirectory() as tmp:
            argv = [a.format(tmp=tmp) for a in argv] + ENTRY_LAUNCH_FLAGS \
                + ["--device", str(dev)]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            # the main path: counts set to 0 just before, read just after
            ops.reset_launch_counts()
            res = serve_trace.run(argv)
            counts = _entry_counts(kernels, ops.launch_counts())
            peak = torch.cuda.max_memory_allocated() / 1e9
            n_attn, n_mamba = mixers(res["config"])
            fields = dict(run=label, arch=res["arch"], requests=res["requests"],
                          tokens=res["tokens"],
                          requested_tokens=res["requested_tokens"],
                          steps=res["steps"], wall_s=f"{res['wall_s']:.3f}",
                          ms_per_step=f"{res['wall_s'] / res['steps'] * 1e3:.2f}",
                          launches=json.dumps(counts),
                          max_allocated_gb=f"{peak:.2f}")
            sched = res["stats"]["sched"]
            fields.update(joins=sched["joins"],
                          pages_parked=sched["pages_parked"],
                          cold_spills=sched["cold_spills"],
                          prefetch_fetches=sched["prefetch"]["fetches_issued"])
            if "slo" in res:
                slo = res["slo"]
                fields.update(
                    goodput_tok_per_step=f"{slo['goodput_tok_per_step']:.4f}",
                    preemptions=slo["preemptions"], shed=slo["shed"],
                    attainment=json.dumps({
                        cls: c["ttft_attainment"]
                        for cls, c in sorted(slo["classes"].items())}))
            if "overlap" in res:
                ov = res["overlap"]
                fields.update(transfers=ov["transfers"],
                              hidden_s=f"{ov['hidden_s']:.4f}",
                              exposed_s=f"{ov['exposed_s']:.4f}",
                              hidden_fraction=ov["hidden_fraction"])
                bad = validate_file(f"{tmp}/trace.json")
                fields["trace_check_errors"] = len(bad)
                assert bad == [], bad[:5]
                assert ov["transfers"] > 0 and ov["hidden_fraction"] is not None
                stats = json.loads(Path(f"{tmp}/stats.json").read_text())
                assert "sched" in stats and "pool" in stats, list(stats)
                fields["stats_json_keys"] = ",".join(sorted(stats))
            log("entry", **fields)
        assert res["tokens"] == res["requested_tokens"], res["tokens"]
        preempted = res.get("slo", {}).get("preemptions", 0)
        assert counts["decode_attention"] > 0, counts
        assert counts["paged_decode_attention"] == 0, counts
        if not preempted:
            assert counts["flash_attention"] == res["requests"] * n_attn, \
                counts
            assert counts["ssd_scan"] == res["requests"] * n_mamba, counts
        if n_mamba:
            assert counts["ssd_scan"] > 0, counts
        torch.cuda.empty_cache()


def entry_quickstart(torch, dev, kernels) -> None:
    """``examples.quickstart.run`` at its own settings (phi3 ``.reduced()``,
    fp32, 60 steps with activation and moment offload, then 16 tokens
    resident and ``kv_offload``): the loss falls, the moments are in
    pinned host memory, the two generations are equal (the example
    raises otherwise); flash and the ring kernel launched."""
    from repro_torch.examples import quickstart
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = quickstart.run(device=dev)
    counts = _entry_counts(kernels, ops.launch_counts())
    s = res["stats"]
    log("entry", run="quickstart",
        losses=json.dumps({k: round(v, 6) for k, v in res["losses"].items()}),
        ms_per_train_step=f"{res['ms_per_step']:.2f}",
        moments=res["moments_device"], moments_pinned=res["moments_pinned"],
        identical=res["identical"], cache_round_trips=res["round_trips"],
        pool_puts=s["pool"]["puts"], pool_gets=s["pool"]["gets"],
        fetches_issued=s["pool"]["transfer"]["issued"],
        launches=json.dumps(counts),
        max_allocated_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
    assert res["losses"][59] < res["losses"][0], res["losses"]
    assert res["identical"] and res["moments_pinned"]
    assert counts["flash_attention"] > 0 and counts["decode_attention"] > 0, \
        counts


def entry_serve_offload(torch, dev, kernels) -> None:
    """``examples.serve_offload``: the paged demo (fp32, B=2, 8 q / 4 kv
    heads of 64, 16 pages of 32 in the host tier, 64 decode steps):
    ``attend`` over every page within ``ENTRY_PAGED_TOL`` of the dense
    oracle, ``attend_fused`` (the paged kernel, launched) within it of
    ``attend``; then ``run_continuous(slo=True)``."""
    from repro_torch.examples import serve_offload
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    res = serve_offload.run(device=dev)
    counts = _entry_counts(kernels, ops.launch_counts())
    s = res["pool"]
    log("entry", run="serve_offload-paged",
        err_all=f"{res['err_all']:.3e}",
        fused_max_abs_diff=f"{res['fused_max_abs_diff']:.3e}",
        fused_bitwise=res["fused_bitwise"], tol=ENTRY_PAGED_TOL,
        top_k=json.dumps({k: dict(fetched=v["fetched"],
                                  err=float(f"{v['err']:.4e}"),
                                  ms=round(v["s"] * 1e3, 3))
                          for k, v in res["top_k"].items()}),
        fused_ms=f"{res['fused_s'] * 1e3:.3f}",
        decode_ms_per_step=f"{res['decode_s'] / 64 * 1e3:.3f}",
        flushes=res["decode_flushes"], length=res["length"],
        buffer_hits=res["buffer_hits"], buffer_misses=res["buffer_misses"],
        pool_puts=s["puts"], pool_gets=s["gets"],
        host_entries=s["tier/host"]["entries"],
        host_backend=s["tier/host"]["backend"],
        fetches_issued=s["transfer"]["issued"],
        waits_blocked=s["transfer"]["waits_blocked"],
        launches=json.dumps(counts))
    assert res["err_all"] <= ENTRY_PAGED_TOL, res["err_all"]
    assert res["fused_max_abs_diff"] <= ENTRY_PAGED_TOL, \
        res["fused_max_abs_diff"]
    assert counts["paged_decode_attention"] == 2, counts   # warm + timed
    ops.reset_launch_counts()
    res = serve_offload.run_continuous(slo=True, device=dev)
    counts = _entry_counts(kernels, ops.launch_counts())
    log("entry", run="serve_offload-continuous-slo", requests=res["requests"],
        tokens=res["tokens"], steps=res["steps"], shed=res["shed"],
        preemptions=res["preemptions"], pages_parked=res["pages_parked"],
        cold_spills=res["cold_spills"], wall_s=f"{res['wall_s']:.3f}",
        launches=json.dumps(counts))
    assert res["requests"] == 10 and counts["decode_attention"] > 0, counts


def entry_train_100m(torch, dev, kernels) -> None:
    """``examples.train_100m.run`` at its defaults (``ENTRY_TRAIN_ARGV``)
    into a temporary ``--ckpt-dir``: the parameter count equals the meta
    count, the mean of the last 25 losses lies below the first 25's, the
    checkpoint of the last step restores the live parameters bit for bit,
    and no kernel launches (training runs the plain path). Logs tok/s, ms
    a step and peak device GB."""
    import tempfile

    from repro_torch.examples import train_100m
    from repro_torch.kernels import ops

    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        res = train_100m.run(ENTRY_TRAIN_ARGV + ["--ckpt-dir", tmp,
                                                 "--device", str(dev)])
        counts = _entry_counts(kernels, ops.launch_counts())
    losses = res["losses"]
    first, last = (sum(x) / len(x) for x in (losses[:25], losses[-25:]))
    expected = train_100m.param_count(train_100m.make_100m_config())
    log("entry", run="train_100m", params=res["params"],
        meta_params=expected, steps=len(losses),
        tok_per_s=f"{res['tokens'] / res['train_s']:.1f}",
        ms_per_step=f"{res['train_s'] / len(losses) * 1e3:.2f}",
        loss_first25=f"{first:.4f}", loss_last25=f"{last:.4f}",
        loss_first=f"{losses[0]:.4f}", loss_last=f"{losses[-1]:.4f}",
        resumed_at=res["resumed_at"], bitwise=res["bitwise"],
        launches=json.dumps(counts),
        max_allocated_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
    assert res["params"] == expected
    assert last < first, (first, last)
    assert res["bitwise"] is True and res["resumed_at"] == len(losses)
    assert not any(counts.values()), counts


def entry_schedule_viz() -> None:
    """``examples.schedule_viz.run`` under the port's ``H100`` spec: the
    planner's modelled totals and peaks (host arithmetic, no card work);
    the refined order's peak at most the early order's."""
    from repro_torch.examples import schedule_viz

    res = schedule_viz.run()
    log("entry", run="schedule_viz", modelled=True,
        **{k: (f"{v:.6f}" if isinstance(v, float) else v)
           for k, v in res.items()})
    assert res["refined_peak_bytes"] <= res["early_peak_bytes"], res


if __name__ == "__main__":
    sys.exit(main())
