"""Readings for the limits of a cell's output check, on the chip at the
cell's own size and load, many seeds in one process: for each seed one
short window at the cell's rate, then on the run's own sample the
program's verdict and the float8 control's, both through the check the
benchmark runs (``runner.verdict``) against the cell's own limits. Not run
by the benchmark; the limits in the cell's file are set from what it
prints.

    python3 perfbench/tools/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--seconds 20] [--lead-in 5] [--rate R] [--codec int8|fp8]

``--codec`` serves with the program's own lower-precision path on (KV pages
quantized from the host tier down), and ``program`` is then that path's
verdict. ``--rate`` serves at another rate than the cell's file states.
"""

import argparse
import dataclasses
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def reading(cell, seed: int, seconds: float, lead_in_s: float, device,
            codec: str = None) -> dict:
    import torch

    from perfbench.harness import serve
    from perfbench.harness.runner import verdict
    opts = None
    if codec:
        from repro_torch.api.config import KVCodecConfig
        opts = {"kv_codec": KVCodecConfig(codec=codec, below_tier="host")}
    win, session = serve.run(cell, seed, seconds, False, device,
                             time.perf_counter(), lead_in_s=lead_in_s,
                             session_options=opts)
    spills = session.stats()["sched"]["cold_spills"]
    session.close()
    del session
    gc.collect()
    torch.cuda.empty_cache()
    out = {"seed": seed, "codec": codec, "rate_req_s": cell.rate,
           "cold_spills": spills}
    for side, control in (("program", False), ("control", True)):
        t = time.perf_counter()
        correct, numbers, info = verdict(cell, win, seed, device,
                                         control=control)
        out[side] = {"correct": correct, **info,
                     "check_s": time.perf_counter() - t}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--lead-in", type=float, default=5.0)
    ap.add_argument("--rate", type=float, default=None)
    ap.add_argument("--codec", default=None)
    args = ap.parse_args()
    import torch

    from perfbench.harness.spec import load_cell
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    if args.rate is not None:
        cell = dataclasses.replace(
            cell, layout=dict(cell.layout, rate_req_s=args.rate))
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        r = reading(cell, seed, args.seconds, args.lead_in, dev, args.codec)
        print("calibrate " + json.dumps({"workload": cell.name, **r}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
