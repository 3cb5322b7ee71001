"""What the per-layer readers (``perfbench/metrics/<name>.py``) share: span
time a step, steps in the window, and the kernels' rooflines from the
device trace matched to the steps that launched them.

A reader is a module with ``read(win) -> Optional[float]``: ``None`` when
it finds nothing to read in the run, and the metric is then left out."""

from __future__ import annotations

import importlib.util
from typing import Callable, Dict, List, Optional, Tuple

from perfbench.harness import counts
from perfbench.harness.spec import BENCH


def reader(name: str) -> Callable:
    """The ``read`` of ``perfbench/metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{len(name)}_{abs(hash(name))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def steps_in_window(win) -> List:
    return [s for s in win.steps if win.t_open <= s.t0 and s.t1 < win.t_close]


def steps_mfu_pct(win, steps) -> Optional[float]:
    """Percent of the bf16 peak: the model FLOPs of ``steps`` over their
    summed host time (each from its call to its return on the host copy of
    the sampled tokens)."""
    c = win.cell.config
    flops = sum(sum(counts.prefill_flops(c, n) for n in s.prefills)
                + sum(counts.decode_flops(c, p) for p in s.decode_pos)
                for s in steps)
    seconds = sum(s.t1 - s.t0 for s in steps)
    if not flops or seconds <= 0:
        return None
    return 100.0 * flops / (seconds * counts.PEAK_BF16_FLOPS)


def span_ms_per_step(win, *names: str) -> Optional[float]:
    """Host milliseconds a step in the named session spans, over the
    window's scheduler steps (``sched/step`` spans)."""
    inside = lambda s: win.t_open <= s < win.t_close        # noqa: E731
    steps = sum(1 for n, s, _ in win.spans if n == "sched/step" and inside(s))
    spans = [e - s for n, s, e in win.spans if n in names and inside(s)]
    if not steps or not spans:
        return None
    return 1e3 * sum(spans) / steps


def kernel_roofline(win, fragment: str,
                    launches: Callable[[object], List[Tuple[float, float]]]
                    ) -> Optional[float]:
    """Percent of the roofline bound: over every step inside the traced
    slice whose launches of the kernel named by ``fragment`` are all seen
    (``launches(step)`` lists each one's FLOPs and bytes, in order), the
    bound time summed over their measured device time summed."""
    dt = win.device_trace
    if dt is None or not dt.events:
        return None
    evs = dt.kernels(fragment)
    bound = measured = 0.0
    j = 0
    for step in win.steps:
        if step.t0 < dt.t_start or step.t1 > dt.t_stop:
            continue
        want = launches(step)
        while j < len(evs) and evs[j][0] < step.t0:
            j += 1
        got = []
        while j < len(evs) and evs[j][0] <= step.t1:
            got.append(evs[j])
            j += 1
        if not want or len(got) != len(want):
            continue
        bound += sum(counts.bound_s(f, b) for f, b in want)
        measured += sum(e - s for s, e in got)
    return 100.0 * bound / measured if measured > 0 else None


def attention_shape(win) -> Dict[str, int]:
    c = win.cell.config
    return {"hq": c["num_attention_heads"], "hkv": c["num_key_value_heads"],
            "d": c["head_dim"], "layers": c["num_hidden_layers"]}
