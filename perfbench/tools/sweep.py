"""Finds a cell's knee: the cell served at several rates in one process, a
short window each, printing per rate the tokens a second, the tails and
whether the backlog (requests due and not yet given a first token) grew
over the window, then the knee: the highest rate below the first whose
backlog grew by more than ``--grow`` requests over its window, and 0.8 x
that. Not run by the benchmark; its output is recorded beside the rate
chosen.

    python3 perfbench/tools/sweep.py --workload <cell> --rates 0.5,1,2 \\
        [--seconds 20] [--seed 7]
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def backlog(served, t: float) -> int:
    return sum(1 for r in served
               if r.due <= t and not (r.stamps and r.stamps[0] <= t))


def sweep_point(cell, rate: float, seed: int, seconds: float, device):
    """One window at ``rate``; returns its numbers."""
    import dataclasses

    import torch

    from perfbench.harness import serve
    from perfbench.harness.stats import window_metrics
    c = dataclasses.replace(cell, layout=dict(cell.layout, rate_req_s=rate))
    win, session = serve.run(c, seed, seconds, False, device,
                             time.perf_counter())
    out = {"rate_req_s": rate, **window_metrics(win.served, win.t_open,
                                                win.t_close)}
    out["backlog_open"] = backlog(win.served, win.t_open)
    out["backlog_close"] = backlog(win.served, win.t_close)
    out["peak_device_gib"] = (win.memory_peak_bytes or 0) / (1 << 30)
    session.close()
    del session, win
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--grow", type=int, default=2)
    args = ap.parse_args()
    import torch

    from perfbench.harness.spec import load_cell
    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    dev = torch.device("cuda", 0)
    knee = None
    for rate in sorted(float(r) for r in args.rates.split(",")):
        out = sweep_point(cell, rate, args.seed, args.seconds, dev)
        print("sweep " + json.dumps({"workload": cell.name, **out}),
              flush=True)
        if out["backlog_close"] - out["backlog_open"] > args.grow:
            break
        knee = rate
    print("knee " + json.dumps({"workload": cell.name, "knee_req_s": knee,
                                "rate_req_s": knee and round(0.8 * knee, 2)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
