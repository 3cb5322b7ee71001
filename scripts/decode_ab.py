"""Resident decode ms a step of the port's ``ServeEngine``, for one or more
source trees in turn, each in a fresh process: the way to hold two commits
against each other on one card.

    git archive <parent> | tar -x -C build/parent
    python scripts/decode_ab.py --tree build/parent --tree . --tree . \\
        --tree build/parent [--out build/decode_ab.jsonl]

Each run puts its tree's ``src`` first on the path, builds that tree's
kernels, and for each architecture (phi3-mini-3.8b and
granite-moe-3b-a800m by default) makes the model at full width and depth
with random bf16 weights from seed 0 on the card. It then times
``ServeEngine.generate`` on B=4 prompts of 512 tokens (max_seq 576), with
64 new tokens and with 1 (the prefill alone), ``--reps`` times each,
interleaved, on the host clock around a synchronize. A decode step is the
difference of the medians over the 63 steps, and again of the minima
(host noise only adds time, so the minima are the steadier estimate of
host-bound work). Each run prints one JSON line per architecture, with
the card's name and power limit, and appends it to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

BATCH, PROMPT, NEW_TOKENS = 4, 512, 64
MAX_SEQ = PROMPT + NEW_TOKENS
ARCHS = ("phi3-mini-3.8b", "granite-moe-3b-a800m")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def measure(tree: str, archs, reps: int):
    """One tree's records (runs in the child process)."""
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import torch
    from repro_torch.configs import REGISTRY
    from repro_torch.kernels import build
    from repro_torch.models.model import build_model
    from repro_torch.serving import ServeEngine

    build.load_library()
    dev = torch.device("cuda")
    for arch in archs:
        cfg = REGISTRY[arch]
        model = build_model(cfg)
        gen = torch.Generator(device=dev).manual_seed(0)
        params = model.init(gen, torch.bfloat16, dev)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                                         generator=gen, device=dev,
                                         dtype=torch.int32)}
        engine = ServeEngine(model, params, max_seq=MAX_SEQ,
                             cache_dtype=torch.bfloat16)

        def wall(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = engine.generate(batch, n)
            torch.cuda.synchronize()
            return time.perf_counter() - t0, out

        _, first = wall(NEW_TOKENS)          # warm
        walls = {NEW_TOKENS: [], 1: []}
        for _ in range(reps):
            for n in walls:
                s, out = wall(n)
                walls[n].append(s)
                if n == NEW_TOKENS:
                    assert torch.equal(out, first), "tokens differ"
        full = statistics.median(walls[NEW_TOKENS])
        pre = statistics.median(walls[1])
        fastest = (min(walls[NEW_TOKENS]) - min(walls[1])) \
            / (NEW_TOKENS - 1) * 1e3
        yield {"tree": tree, "arch": arch, "card": card(),
               "decode_ms_per_step": (full - pre) / (NEW_TOKENS - 1) * 1e3,
               "decode_ms_per_step_min": fastest,
               "prefill_ms": pre * 1e3, "generate_s": full,
               "generate_s_all": walls[NEW_TOKENS], "prefill_s_all": walls[1],
               "reps": reps, "first_tokens": first[0, :8].tolist()}
        del engine, params
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", required=True,
                    help="a source tree (holds src/repro_torch); repeatable")
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--out", default=None, help="append JSON lines here")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    archs = args.arch or list(ARCHS)
    if args.child:
        for rec in measure(args.tree[0], archs, args.reps):
            print(json.dumps(rec), flush=True)
        return 0
    records = []
    for tree in args.tree:
        cmd = [sys.executable, os.path.abspath(__file__), "--child",
               "--tree", tree, "--reps", str(args.reps)]
        for a in archs:
            cmd += ["--arch", a]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                print(line, flush=True)
                records.append(json.loads(line))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            for rec in records:
                f.write(json.dumps(rec) + "\n")
    # same tokens from every tree: the runs did the same work
    for arch in archs:
        toks = {json.dumps(r["first_tokens"]) for r in records
                if r["arch"] == arch}
        assert len(toks) == 1, (arch, toks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
