"""Three-term roofline analysis (the counterpart of
``repro.roofline.analysis``).

    compute term    = FLOPs / peak_FLOP/s                (per device)
    memory term     = HBM bytes / HBM_bw                 (per device)
    collective term = collective_bytes / link_bw         (per device)

The reference reads its terms out of a compiled XLA executable
(``roofline_from_compiled``). The port has no executable: it traces the
call instead (:func:`roofline_from_trace`), one device's ops as they run,
on real tensors or under ``FakeTensorMode`` (the dry-run). The default
hardware is the port's ``H100``; its ``link_bw`` is NVLink's 450 GB/s,
which holds only between the cards of one 8-card host, so on a larger
mesh the collective term is a lower bound.

:func:`collective_bytes` and :func:`model_flops` are the reference's,
and :class:`RooflineTerms` has its fields and ``row()`` keys.
"""

from __future__ import annotations

import contextlib
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import ModelConfig
from repro_torch.core.costmodel import H100, HardwareSpec

_DTYPE_BYTES = {
    "f64": 8, "s64": 8, "u64": 8,
    "f32": 4, "s32": 4, "u32": 4,
    "bf16": 2, "f16": 2, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1,
    "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1,
}

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter",
                  "all-to-all", "collective-permute")

# matches e.g. "bf16[16,512]{1,0}": dtype + dims
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
# a collective instruction line: "%name = <shape(s)> <op>("
_INSTR_RE = re.compile(
    r"=\s+(.+?)\s+(" + "|".join(COLLECTIVE_OPS) + r")(?:-start|-done)?\(")


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_str):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                if d:
                    n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def collective_bytes(hlo_text: str) -> Dict[str, int]:
    """Sum output-operand bytes of every collective in optimized HLO,
    keyed by op kind. ``-done`` ops are skipped (their ``-start`` carries
    the payload)."""
    out: Dict[str, int] = {k: 0 for k in COLLECTIVE_OPS}
    for line in hlo_text.splitlines():
        m = _INSTR_RE.search(line)
        if not m:
            continue
        if "-done(" in line:
            continue
        shape_str, op = m.group(1), m.group(2)
        out[op] += _shape_bytes(shape_str)
    return out


def model_flops(cfg: ModelConfig, tokens: int, train: bool = True) -> float:
    """MODEL_FLOPS = 6·N·D (train: fwd+bwd) or 2·N·D (inference fwd only),
    with N = active params (MoE: top-k only)."""
    factor = 6.0 if train else 2.0
    return factor * cfg.active_param_count() * tokens


@dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    hbm_bytes: float
    coll_bytes: int
    coll_breakdown: Dict[str, int] = field(default_factory=dict)
    model_flops: float = 0.0
    per_device_peak_bytes: float = 0.0

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        return 0.0 if self.flops == 0 else self.model_flops / self.flops

    def row(self) -> Dict[str, object]:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "peak_bytes_per_device": self.per_device_peak_bytes,
        }


# functional collectives (the ops a DTensor redistribution issues) by the
# reference's kind names
_COLLECTIVE_KIND = (("all_gather", "all-gather"), ("all_reduce", "all-reduce"),
                    ("reduce_scatter", "reduce-scatter"),
                    ("all_to_all", "all-to-all"),
                    ("permute", "collective-permute"))


def _collective_kind(func) -> Optional[str]:
    ns = func.namespace
    if ns not in ("_c10d_functional", "c10d_functional", "c10d"):
        return None
    name = func._overloadpacket.__name__
    for key, kind in _COLLECTIVE_KIND:
        if key in name:
            return kind
    return None


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


class _OpTrace(TorchDispatchMode):
    """Counts one device's work at the ops that run on its tensors. An op
    on ``DTensor``s is handed back (``NotImplemented``) so the ``DTensor``
    runs it, and the local ops it issues (on the shards, and the
    collectives of any redistribution) come back here to be counted."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.flops = 0.0
        self.hbm_bytes = 0
        self.coll: Dict[str, int] = {k: 0 for k in COLLECTIVE_OPS}
        self.muted = 0

    @contextlib.contextmanager
    def mute_meta_propagation(self):
        """``DTensor`` derives an op's global output shape by running the
        op once on fake global tensors (the first time it meets that
        signature). That run is no device's work: it is not counted."""
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        orig = ShardingPropagator._propagate_tensor_meta_non_cached

        def muted(prop, *a, **kw):
            self.muted += 1
            try:
                return orig(prop, *a, **kw)
            finally:
                self.muted -= 1
        ShardingPropagator._propagate_tensor_meta_non_cached = muted
        try:
            yield
        finally:
            ShardingPropagator._propagate_tensor_meta_non_cached = orig

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        packet = func._overloadpacket
        if packet not in self._flop_registry and func.namespace == "aten":
            # a composite op (``matmul`` under inference mode reaches the
            # mode whole) runs as its decomposition, whose ops come back
            # here, as FlopCounterMode does
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if self.muted or not any(True for _ in _tensors(out)):
            return out
        kind = _collective_kind(func)
        if kind is not None:
            self.coll[kind] += _nbytes(out)
            return out
        if packet in self._flop_registry:
            self.flops += self._flop_registry[packet](*args, **kwargs,
                                                      out_val=out)
        if not func.is_view and not packet.__name__.startswith("wait"):
            self.hbm_bytes += _nbytes(args) + _nbytes(list(kwargs.values())) \
                + _nbytes(out)
        return out


def roofline_from_trace(fn: Callable, *args, cfg: Optional[ModelConfig] = None,
                        tokens: int = 0, n_devices: int = 1,
                        hw: HardwareSpec = H100, train: bool = True,
                        arg_bytes: Optional[int] = None):
    """Run ``fn(*args)`` and derive the three terms from the ops it ran on
    one device. Returns ``(fn's result, RooflineTerms)``.

    - FLOPs: ``torch.utils.flop_counter``'s formulas (the products and
      convolutions ``FlopCounterMode`` counts) over each op's **local**
      tensors: under a mesh, the shards this device holds, not the
      ``DTensor``'s global shape (which would count every device's work).
    - HBM bytes: every op that is not a view reads each tensor argument
      once and writes each output once, at their own sizes; views and
      collectives move nothing, nor does an op with no tensor output.
      Eager PyTorch writes every intermediate to
      memory, so no op is taken as fused into another.
    - Collective bytes: the output size of every functional collective
      (what a ``DTensor`` redistribution issues), by the reference's kind
      names.
    - ``per_device_peak_bytes``: ``arg_bytes``, the bytes of this device's
      shards of the arguments, as the caller reckons them
      (``launch.shardings.local_bytes``). XLA's temp and alias sizes have
      no counterpart in a trace and are not measured.

    Work inside a hand-written kernel, which the port calls outside the
    dispatcher, is not seen: the reference's HLO analysis does not see
    into a Pallas custom call either. ``model_flops`` is divided by
    ``n_devices`` as in the reference.
    """
    trace = _OpTrace()
    with trace.mute_meta_propagation(), trace:
        result = fn(*args)
    coll_total = int(sum(trace.coll.values()))
    mf = model_flops(cfg, tokens, train) / max(n_devices, 1) \
        if cfg is not None else 0.0
    terms = RooflineTerms(
        compute_s=trace.flops / hw.flops,
        memory_s=trace.hbm_bytes / hw.hbm_bw,
        collective_s=coll_total / hw.link_bw,
        flops=float(trace.flops),
        hbm_bytes=float(trace.hbm_bytes),
        coll_bytes=coll_total,
        coll_breakdown={k: int(v) for k, v in trace.coll.items()},
        model_flops=mf,
        per_device_peak_bytes=float(arg_bytes or 0),
    )
    return result, terms
