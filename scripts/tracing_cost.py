"""What tracing costs a benchmark cell's ``output_tok_s``: the cell served
with tracing off, with the program's telemetry alone (the session's tracer
and clocks), with the device profiler alone, and with both (what
``perfbench/run.py --trace 1`` runs), each run in a process of its own
through ``perfbench.harness.runner.execute``, output check included. Seeds
run in turn; the set-ups rotate within each seed. Prints one JSON line a
run (a traced run's per-layer metrics and idle breakdown too) and, per
set-up, the median ``output_tok_s`` over the seeds with its cost against
the untraced median.

    python3 scripts/tracing_cost.py --workload <cell> --seeds 1,2,3 \\
        [--seconds 51] [--setups untraced,telemetry,profiler,both] [--out FILE]
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]

#: set-up -> (device profiler on, program telemetry on)
SETUPS = {"untraced": (False, False), "telemetry": (False, True),
          "profiler": (True, False), "both": (True, True)}


def one(workload: str, setup: str, seed: int, seconds: float) -> dict:
    """One run of ``workload`` under ``setup`` in this process."""
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from perfbench.harness import runner, serve
    from perfbench.harness.spec import load_cell
    from repro_torch.api.config import TelemetryConfig

    profiler, telemetry = SETUPS[setup]
    tel = TelemetryConfig(enable=telemetry, ring_capacity=serve.TRACE_RING)
    result, notes = runner.execute(
        load_cell(workload), seed, seconds, profiler,
        torch.device("cuda", 0), T_START, session_options={"telemetry": tel})
    out = {"workload": workload, "setup": setup, "seed": seed,
           "correct": result["correct"],
           "output_tok_s": notes["output_tok_s"],
           "itl_p95_ms": notes["itl_p95_ms"],
           "steps_in_window": notes["steps_in_window"],
           "device": result["device"]}
    if profiler:
        out["per_layer"] = {k: v["value"] for k, v in
                            result["metrics"].items()}
        out["breakdown"] = result.get("breakdown")
        out["trace_offset_drift_s"] = notes.get("trace_offset_drift_s")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds, e.g. 1,2,3")
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--setups", default=",".join(SETUPS),
                    help="comma-separated set-ups to run (default: all four)")
    ap.add_argument("--out", default=None, help="append the JSON lines here")
    ap.add_argument("--one", choices=sorted(SETUPS), default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.one is not None:
        print(json.dumps(one(args.workload, args.one, seeds[0],
                             args.seconds)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    names = args.setups.split(",")
    rates = {s: [] for s in names}
    for i, seed in enumerate(seeds):
        k = i % len(names)
        for setup in names[k:] + names[:k]:
            proc = subprocess.run(
                [sys.executable, __file__, "--workload", args.workload,
                 "--seeds", str(seed), "--seconds", str(args.seconds),
                 "--one", setup], capture_output=True, text=True, cwd=ROOT)
            if proc.returncode != 0:
                print(f"{setup} seed {seed} failed:\n{proc.stderr[-4000:]}",
                      flush=True)
                continue
            line = proc.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
            rates[setup].append(json.loads(line)["output_tok_s"])
    base = statistics.median(rates["untraced"]) if rates.get("untraced") \
        else None
    for setup in names:
        if not rates[setup]:
            continue
        med = statistics.median(rates[setup])
        cost = None if not base else 100.0 * (1.0 - med / base)
        print(json.dumps({"workload": args.workload, "setup": setup,
                          "output_tok_s": rates[setup], "median": med,
                          "cost_pct": cost}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
