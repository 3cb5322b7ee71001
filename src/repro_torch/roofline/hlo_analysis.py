"""Loop-aware static analysis of optimized (post-SPMD) HLO text.

``compiled.cost_analysis()`` counts each ``while`` body ONCE, which makes a
scan-over-layers model look ~n_layers× cheaper than it is. XLA records the
real trip count in ``backend_config={"known_trip_count":{"n":...}}``, so we
parse the module into computations, walk the call graph from ENTRY
(while bodies inherit multiplier × trip_count; fusions/calls inherit ×1),
and accumulate per-instruction:

- FLOPs:            dot ops — 2 · |result| · Π(lhs contracting dims)
- HBM bytes:        per top-level instruction, operands + results (the
                    fusion is XLA's memory-traffic unit)
- collective bytes: result sizes of all-reduce / all-gather /
                    reduce-scatter / all-to-all / collective-permute

This is the §Roofline source for HLO_FLOPs / HLO_bytes / collective_bytes.
The port's copy of ``repro.roofline.hlo_analysis``, plain Python over HLO
text: it reads a module that XLA printed, wherever it came from.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

_DTYPE_BYTES = {
    "f64": 8, "s64": 8, "u64": 8, "c64": 8, "c128": 16,
    "f32": 4, "s32": 4, "u32": 4,
    "bf16": 2, "f16": 2, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1,
    "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1, "f8e3m4": 1,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_INSTR_RE = re.compile(r"^\s+(?:ROOT\s+)?%([\w\.\-]+)\s+=\s+(.*?)\s+([\w\-]+)\((.*)$")
_COMP_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w\.\-]+)\s+\(.*\)\s*->")
_TRIP_RE = re.compile(r'"known_trip_count":\{"n":"(\d+)"\}')
_CALLS_RE = re.compile(r"(?:calls|to_apply|body)=%?([\w\.\-]+)")
_COND_RE = re.compile(r"condition=%?([\w\.\-]+)")
_OPERAND_RE = re.compile(r"%([\w\.\-]+)")
_DOT_LHS_CONTRACT = re.compile(r"lhs_contracting_dims=\{([\d,]*)\}")
_DOT_LHS_BATCH = re.compile(r"lhs_batch_dims=\{([\d,]*)\}")

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter",
                  "all-to-all", "collective-permute")

_SKIP_BYTES_OPS = {
    "parameter", "constant", "tuple", "get-tuple-element", "bitcast",
    "after-all", "iota", "while", "conditional", "call", "partition-id",
    "replica-id", "copy-start", "copy-done", "reshape",
}

# bare elementwise ops: the CPU backend leaves many unfused that the TPU
# backend would fuse into neighbours — modeling them as free approximates
# TPU fusion granularity (documented assumption; see module docstring)
_FUSABLE_OPS = {
    "convert", "multiply", "add", "subtract", "divide", "select", "compare",
    "exponential", "tanh", "maximum", "minimum", "negate", "abs", "and",
    "or", "not", "xor", "log", "power", "rsqrt", "sqrt", "floor", "ceil",
    "clamp", "sign", "is-finite", "reduce-precision", "round-nearest-afz",
    "exponential-minus-one", "log-plus-one", "atan2", "remainder",
    "shift-left", "shift-right-logical", "shift-right-arithmetic",
}

# ops whose first operand is a large buffer they only touch a slice of
_SLICING_OPS = {"dynamic-slice", "gather", "slice"}
_UPDATING_OPS = {"dynamic-update-slice", "scatter"}


def _shape_dims(shape_str: str) -> List[Tuple[str, List[int]]]:
    out = []
    for dtype, dims in _SHAPE_RE.findall(shape_str):
        if dtype not in _DTYPE_BYTES:
            continue
        out.append((dtype, [int(d) for d in dims.split(",") if d]))
    return out


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for dtype, dims in _shape_dims(shape_str):
        n = 1
        for d in dims:
            n *= d
        total += n * _DTYPE_BYTES[dtype]
    return total


@dataclass
class Instruction:
    name: str
    shape: str
    op: str
    rest: str


@dataclass
class Computation:
    name: str
    instrs: List[Instruction] = field(default_factory=list)
    symbols: Dict[str, str] = field(default_factory=dict)  # name -> shape str


def parse_module(text: str) -> Dict[str, Computation]:
    comps: Dict[str, Computation] = {}
    cur: Optional[Computation] = None
    for line in text.splitlines():
        if line and not line[0].isspace():
            m = _COMP_RE.match(line)
            if m:
                cur = Computation(m.group(1))
                comps[cur.name] = cur
                if line.startswith("ENTRY"):
                    comps["__entry__"] = cur
            continue
        if cur is None:
            continue
        m = _INSTR_RE.match(line)
        if not m:
            # parameter lines: "  %p = TYPE parameter(0)" match the instr
            # regex; tuple-typed ones may not — capture shapes generically
            pm = re.match(r"^\s+(?:ROOT\s+)?%([\w\.\-]+)\s+=\s+(.*?)\s+parameter\(", line)
            if pm:
                cur.symbols[pm.group(1)] = pm.group(2)
                cur.instrs.append(Instruction(pm.group(1), pm.group(2), "parameter", ""))
            continue
        name, shape, op, rest = m.groups()
        cur.symbols[name] = shape
        cur.instrs.append(Instruction(name, shape, op, rest))
    return comps


def _multipliers(comps: Dict[str, Computation]) -> Dict[str, float]:
    entry = comps.get("__entry__")
    mult: Dict[str, float] = {}
    if entry is None:
        return {name: 1.0 for name in comps}
    mult[entry.name] = 1.0
    # BFS over the call graph
    stack = [entry.name]
    seen_edges = set()
    while stack:
        cname = stack.pop()
        comp = comps.get(cname)
        if comp is None:
            continue
        m = mult.get(cname, 1.0)
        for ins in comp.instrs:
            if ins.op == "while":
                trip = 1
                tm = _TRIP_RE.search(ins.rest)
                if tm:
                    trip = int(tm.group(1))
                bm = _CALLS_RE.search(ins.rest)
                cm = _COND_RE.search(ins.rest)
                if bm:
                    child = bm.group(1)
                    key = (cname, child, ins.name)
                    if key not in seen_edges:
                        seen_edges.add(key)
                        mult[child] = mult.get(child, 0.0) + m * trip
                        stack.append(child)
                if cm:
                    child = cm.group(1)
                    key = (cname, child, ins.name + "#cond")
                    if key not in seen_edges:
                        seen_edges.add(key)
                        mult[child] = mult.get(child, 0.0) + m * trip
                        stack.append(child)
            else:
                for cm_ in _CALLS_RE.finditer(ins.rest):
                    child = cm_.group(1)
                    key = (cname, child, ins.name)
                    if key not in seen_edges:
                        seen_edges.add(key)
                        mult[child] = mult.get(child, 0.0) + m
                        stack.append(child)
    return mult


def _dot_flops(ins: Instruction, comp: Computation) -> float:
    dims = _shape_dims(ins.shape)
    if not dims:
        return 0.0
    _, rdims = dims[0]
    n_out = 1
    for d in rdims:
        n_out *= d
    lhs_m = _OPERAND_RE.search(ins.rest)
    contract = _DOT_LHS_CONTRACT.search(ins.rest)
    k = 1
    if lhs_m and contract:
        lhs_shape = comp.symbols.get(lhs_m.group(1))
        if lhs_shape:
            ldims = _shape_dims(lhs_shape)
            if ldims:
                _, ld = ldims[0]
                for ci in [int(x) for x in contract.group(1).split(",") if x]:
                    if ci < len(ld):
                        k *= ld[ci]
    return 2.0 * n_out * k


def _fusion_bytes(ins: Instruction, comp: Computation,
                  comps: Dict[str, Computation]) -> float:
    """Traffic of a fusion = result + per-parameter bytes actually read.
    A parameter whose only in-fusion uses are slicing ops contributes the
    slice sizes, not the full buffer (fused dynamic-slice of stacked layer
    params inside a scan body reads one layer, not all of them)."""
    total = float(_shape_bytes(ins.shape))
    cm = _CALLS_RE.search(ins.rest)
    fused = comps.get(cm.group(1)) if cm else None
    operand_names = [om.group(1) for om in
                     _OPERAND_RE.finditer(ins.rest.split(" calls=")[0])]
    operand_shapes = [comp.symbols.get(n) for n in operand_names]
    if fused is None:
        return total + sum(_shape_bytes(s) for s in operand_shapes if s)
    # order of parameter(i) instructions maps to operand order
    params = [i for i in fused.instrs if i.op == "parameter"]
    param_uses: Dict[str, List[Instruction]] = {p.name: [] for p in params}
    for fi in fused.instrs:
        if fi.op == "parameter":
            continue
        for om in _OPERAND_RE.finditer(fi.rest):
            if om.group(1) in param_uses:
                param_uses[om.group(1)].append(fi)
    for idx, p in enumerate(params):
        oshape = operand_shapes[idx] if idx < len(operand_shapes) else None
        full = _shape_bytes(oshape) if oshape else _shape_bytes(p.shape)
        uses = param_uses.get(p.name, [])
        if uses and all(u.op in _SLICING_OPS for u in uses):
            total += sum(_shape_bytes(u.shape) for u in uses)
        elif uses and all(u.op in _UPDATING_OPS for u in uses):
            upd = 0
            for u in uses:
                ops_ = [fused.symbols.get(om.group(1))
                        for om in _OPERAND_RE.finditer(u.rest)]
                upd += _shape_bytes(ops_[1]) if len(ops_) > 1 and ops_[1] else _shape_bytes(u.shape)
            total += min(full, upd)
        else:
            total += full
    return total


@dataclass
class HloStats:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    coll_breakdown: Dict[str, float] = field(default_factory=dict)
    n_collectives: int = 0


def analyze(text: str) -> HloStats:
    comps = parse_module(text)
    comps_by_name = {k: v for k, v in comps.items() if k != "__entry__"}
    mult = _multipliers(comps)
    stats = HloStats(coll_breakdown={k: 0.0 for k in COLLECTIVE_OPS})

    # computations that are fusion bodies: their traffic is accounted at the
    # fusion instruction — only dot FLOPs are collected inside them
    fusion_bodies = set()
    for comp in comps_by_name.values():
        for ins in comp.instrs:
            if ins.op == "fusion":
                cm = _CALLS_RE.search(ins.rest)
                if cm:
                    fusion_bodies.add(cm.group(1))

    for cname, comp in comps_by_name.items():
        m = mult.get(cname, 0.0)
        if m == 0.0:
            continue
        in_fusion_body = cname in fusion_bodies
        for ins in comp.instrs:
            base_op = ins.op
            if base_op.endswith("-start"):
                base_op = base_op[:-6]
            if base_op == "dot":
                stats.flops += m * _dot_flops(ins, comp)
            if base_op in COLLECTIVE_OPS:
                b = _shape_bytes(ins.shape)
                stats.collective_bytes += m * b
                stats.coll_breakdown[base_op] += m * b
                stats.n_collectives += int(m)
            if (in_fusion_body or ins.op in _SKIP_BYTES_OPS
                    or ins.op in _FUSABLE_OPS or ins.op.endswith("-done")
                    or base_op in COLLECTIVE_OPS):
                continue
            if ins.op in _SLICING_OPS:
                # reads + writes only the extracted slice
                stats.hbm_bytes += m * 2 * _shape_bytes(ins.shape)
                continue
            if ins.op in _UPDATING_OPS:
                # touches only the update operand's extent (operand #1)
                ops_ = [comp.symbols.get(om.group(1))
                        for om in _OPERAND_RE.finditer(ins.rest)]
                upd = ops_[1] if len(ops_) > 1 and ops_[1] else ins.shape
                stats.hbm_bytes += m * 2 * _shape_bytes(upd)
                continue
            if ins.op == "broadcast":
                stats.hbm_bytes += m * _shape_bytes(ins.shape)
                continue
            if ins.op == "fusion":
                stats.hbm_bytes += m * _fusion_bytes(ins, comp, comps_by_name)
                continue
            # default: operands + result (the fusion is the traffic unit)
            nbytes = _shape_bytes(ins.shape)
            for om in _OPERAND_RE.finditer(ins.rest.split(" calls=")[0]):
                oshape = comp.symbols.get(om.group(1))
                if oshape:
                    nbytes += _shape_bytes(oshape)
            stats.hbm_bytes += m * nbytes
    return stats
