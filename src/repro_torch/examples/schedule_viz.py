"""Visualize HyperOffload's graph-driven execution-order optimization
(the paper's Figures 3/4) as ASCII timelines (the counterpart of the
repository's ``examples/schedule_viz.py``).

    PYTHONPATH=src python -m repro_torch.examples.schedule_viz

Builds a layer chain with pool-resident weights, plans it three ways —
(a) reactive runtime swapping, (b) operatorized but adversarially-early
prefetch order (Fig. 4b), (c) Algorithm-1-refined just-in-time order
(Fig. 4c) — and prints compute/DMA lanes plus peak memory for each.

Everything here is the planner's cost model, computed on the host: the
ms and GB printed are what the model predicts for ``hw`` (the port's
``H100`` spec by default; the reference script uses ``TPU_V5E``, which
``run(hw=TPU_V5E)`` reproduces line for line), not a measurement.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

from repro_torch.core import insertion, memsim, schedule, timeline
from repro_torch.core.costmodel import H100, HardwareSpec
from repro_torch.core.ir import Graph


def build_chain(n=6, wbytes=256 << 20, flops=2e12):
    g = Graph()
    g.add_tensor("x", 1 << 20)
    prev = "x"
    for i in range(n):
        g.add_tensor(f"w{i}", wbytes, "weight", "remote")
        g.add_tensor(f"h{i}", 1 << 20)
        g.compute(f"f{i}", inputs=(prev, f"w{i}"), outputs=(f"h{i}",),
                  flops=flops, hbm_bytes=1e6)
        prev = f"h{i}"
    return g


def ascii_timeline(tl, width=78):
    total = tl.total
    lanes = {"compute": [], "r2d": [], "d2r": []}
    for name, (s, e, stream) in tl.schedule.items():
        if stream in lanes and e > s:
            lanes[stream].append((s, e, name))
    out = []
    for lane, items in lanes.items():
        if not items:
            continue
        row = [" "] * width
        for s, e, name in sorted(items):
            a = int(s / total * (width - 1))
            b = max(a + 1, int(e / total * (width - 1)))
            ch = name.split("::")[-1][0] if "::" in name else name[1]
            for i in range(a, min(b, width)):
                row[i] = ch if row[i] == " " else "#"
        out.append(f"  {lane:8s} |{''.join(row)}|")
    return "\n".join(out)


def run(hw: HardwareSpec = H100) -> Dict[str, float]:
    """Print the three timelines under ``hw``'s cost model; return the
    modelled totals and exposed transfer time (s) and peaks (bytes)."""
    g = build_chain()

    print("=== (a) reactive runtime swapping (paper §3.1) ===")
    cap = 3 * (256 << 20)
    tl_re = timeline.simulate_reactive(g.residentize(), hw, cap)
    print(f"  total {tl_re.total * 1e3:.1f} ms, {tl_re.stalls} synchronous "
          f"stalls, exposed {tl_re.exposed_comm * 1e3:.1f} ms\n")

    g2 = insertion.insert_cache_ops(g, hw)

    print("=== (b) operatorized, adversarial early-prefetch order (Fig. 4b) ===")
    pre = [n for n in g2.order() if g2.nodes[n].kind == "prefetch"]
    rest = [n for n in g2.order() if g2.nodes[n].kind != "prefetch"]
    early = pre + rest
    tl_e = timeline.simulate(g2, hw, early)
    mem_e = memsim.simulate(g2, early)
    print(f"  total {tl_e.total * 1e3:.1f} ms, exposed "
          f"{tl_e.exposed_comm * 1e3:.1f} ms, peak {mem_e.peak_bytes / 1e9:.2f} GB")
    print(ascii_timeline(tl_e), "\n")

    print("=== (c) Algorithm 1 refined just-in-time order (Fig. 4c) ===")
    refined = schedule.refine_order(g2, hw, early)
    tl_r = timeline.simulate(g2, hw, refined)
    mem_r = memsim.simulate(g2, refined)
    print(f"  total {tl_r.total * 1e3:.1f} ms, exposed "
          f"{tl_r.exposed_comm * 1e3:.1f} ms, peak {mem_r.peak_bytes / 1e9:.2f} GB")
    print(ascii_timeline(tl_r))
    print(f"\npeak memory: {mem_e.peak_bytes / 1e9:.2f} → "
          f"{mem_r.peak_bytes / 1e9:.2f} GB; reactive {tl_re.total * 1e3:.0f} ms "
          f"→ planned {tl_r.total * 1e3:.0f} ms")
    return dict(hw=hw.name, reactive_s=tl_re.total,
                reactive_stalls=tl_re.stalls,
                reactive_exposed_s=tl_re.exposed_comm,
                early_s=tl_e.total, early_exposed_s=tl_e.exposed_comm,
                early_peak_bytes=mem_e.peak_bytes,
                refined_s=tl_r.total, refined_exposed_s=tl_r.exposed_comm,
                refined_peak_bytes=mem_r.peak_bytes)


def main(argv: Optional[Sequence[str]] = None) -> int:
    argparse.ArgumentParser(
        prog="python -m repro_torch.examples.schedule_viz",
        description="The planner's timelines, modelled for the H100."
    ).parse_args(argv)
    run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
