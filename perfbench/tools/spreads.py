"""Quartile spreads of a cell's full sets, the numbers its bounds are set
from: each file given holds one run's output, its last line the result.
Files are grouped into sets by the ``--set`` fragment of their names.

    python3 perfbench/tools/spreads.py --sets set1,set2 runs/cell_set*.out

For each set and each end-to-end metric: the median and the spread, (Q3 -
Q1) / median by ``statistics.quantiles(values, n=4)``; ``setup_s`` leaves
out the first set's first run, which builds the kernels.
"""

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def last_result(path: str) -> dict:
    lines = [ln for ln in open(path) if ln.startswith("{")]
    return json.loads(lines[-1]) if lines else {}


def main() -> int:
    from perfbench.harness.stats import quartile_spread
    ap = argparse.ArgumentParser()
    ap.add_argument("--sets", default="set1,set2")
    ap.add_argument("files", nargs="+")
    args = ap.parse_args()
    tags = args.sets.split(",")
    widest = {}
    for k, tag in enumerate(tags):
        runs = [last_result(f) for f in sorted(args.files) if tag in f]
        runs = [r for r in runs if r]
        print(f"{tag}: {len(runs)} runs, correct {[r['correct'] for r in runs]}, "
              f"checks {[r['checks'] for r in runs]}")
        names = sorted({n for r in runs for n in r["metrics"]})
        for n in names:
            vals = [r["metrics"][n]["value"] for r in runs if n in r["metrics"]]
            use = vals[1:] if (n == "setup_s" and k == 0) else vals
            s = quartile_spread(use)
            widest[n] = max(widest.get(n, 0.0), s)
            print(f"  {n:16s} median {statistics.median(use):.6g} "
                  f"spread {s:.4f} values {vals}")
    print("widest " + json.dumps(widest))
    return 0


if __name__ == "__main__":
    sys.exit(main())
