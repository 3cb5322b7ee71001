"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``): one run
of one cell of ``BENCHMARK.json``.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the chips the cell asks
for. Prints the device on an early line, the window's counts on standard
error, the number the output check compared beside its limit as the last
lines of standard error, and one JSON object as the last line of standard
output: ``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1``
its per-layer metrics (the session's telemetry and the device profiler
on). Exits non-zero, printing no result, without enough CUDA devices, or if
the JAX package or JAX itself was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the program's kernel builds and any compiler cache stay inside the checkout,
# at fixed paths, so only a checkout's first run builds
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / sub)
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

#: top-level module names that may not be loaded (the JAX package and JAX)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names) -> list:
    """The loaded modules whose top-level name (before the first dot) is
    one of ``FORBIDDEN``, compared whole: ``repro_torch`` is not
    ``repro``."""
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def card_line(torch, n: int) -> str:
    """The device, its count, and nvidia-smi's power limit and SM clocks."""
    try:
        smi = subprocess.run(
            ["nvidia-smi",
             "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = [f"unavailable ({e})"]
    return (f"device {torch.cuda.get_device_name(0)} count {n}; nvidia-smi: "
            + " | ".join(smi))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from perfbench.harness.runner import execute
    from perfbench.harness.spec import load_cell

    cell = load_cell(args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s); "
              f"cuda available: {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    print(card_line(torch, torch.cuda.device_count()), flush=True)
    result, notes = execute(cell, args.seed, args.seconds, bool(args.trace),
                            torch.device("cuda", 0), T_START)
    bad = forbidden_modules(list(sys.modules))
    if bad:
        print(f"perfbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    print("window " + json.dumps(notes, default=str), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
