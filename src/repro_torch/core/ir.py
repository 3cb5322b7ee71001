"""Layer-level computation-graph IR with first-class cache operators.

This is the analogue of the paper's MindIR extension (§4.2): compute nodes
carry analytic FLOP/byte costs; ``prefetch`` / ``store`` / ``detach`` nodes
represent remote-pool traffic and participate in dependency analysis and
topological ordering exactly like compute. Memory semantics (used by
``memsim`` and ``timeline``):

- a tensor is *device-resident* from its producing node (compute or
  prefetch) until freed — after its last consumer for ordinary tensors,
  or by an explicit ``detach`` for persistent ones (weights, states);
- ``store t`` copies t device→remote (t must be device-resident);
- ``detach t`` drops the device copy (legal only if a remote copy exists
  or t has no later consumer);
- ``prefetch t`` copies remote→device (a remote copy must exist; weights
  and states may start remote-resident).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

CACHE_KINDS = ("prefetch", "store", "detach")


@dataclass(frozen=True)
class TensorInfo:
    name: str
    nbytes: int
    # "activation" — produced on device during the step
    # "weight"     — persistent input, device-resident by default
    # "state"      — persistent (optimizer/KV), may start remote
    klass: str = "activation"
    initial_location: str = "device"   # device | remote


@dataclass
class Node:
    name: str
    kind: str                      # "compute" | "prefetch" | "store" | "detach"
    inputs: Tuple[str, ...] = ()   # tensors read (compute only)
    outputs: Tuple[str, ...] = ()  # tensors produced (compute only)
    flops: float = 0.0
    hbm_bytes: float = 0.0         # bytes touched in HBM (compute roofline)
    tensor: Optional[str] = None   # cache ops: the tensor moved
    after: Tuple[str, ...] = ()    # extra explicit control deps (node names)

    @property
    def is_cache_op(self) -> bool:
        return self.kind in CACHE_KINDS

    def reads(self) -> Tuple[str, ...]:
        if self.kind == "compute":
            return self.inputs
        if self.kind in ("store",):
            return (self.tensor,)
        return ()

    def writes(self) -> Tuple[str, ...]:
        if self.kind == "compute":
            return self.outputs
        if self.kind == "prefetch":
            return (self.tensor,)
        return ()


class Graph:
    """A DAG of nodes over named tensors. Node insertion order is preserved
    and serves as the default (valid) topological order."""

    def __init__(self) -> None:
        self.nodes: Dict[str, Node] = {}
        self.tensors: Dict[str, TensorInfo] = {}

    # -- construction -------------------------------------------------------
    def add_tensor(self, name: str, nbytes: int, klass: str = "activation",
                   initial_location: str = "device") -> TensorInfo:
        if name in self.tensors:
            raise ValueError(f"duplicate tensor {name!r}")
        t = TensorInfo(name, int(nbytes), klass, initial_location)
        self.tensors[name] = t
        return t

    def add_node(self, node: Node) -> Node:
        if node.name in self.nodes:
            raise ValueError(f"duplicate node {node.name!r}")
        for t in (*node.reads(), *node.writes()):
            if t not in self.tensors:
                raise ValueError(f"node {node.name!r} references unknown tensor {t!r}")
        self.nodes[node.name] = node
        return node

    def compute(self, name: str, inputs: Sequence[str] = (),
                outputs: Sequence[str] = (), flops: float = 0.0,
                hbm_bytes: float = 0.0, after: Sequence[str] = ()) -> Node:
        return self.add_node(Node(name, "compute", tuple(inputs), tuple(outputs),
                                  flops, hbm_bytes, after=tuple(after)))

    def prefetch(self, tensor: str, name: Optional[str] = None,
                 after: Sequence[str] = ()) -> Node:
        return self.add_node(Node(name or f"prefetch::{tensor}", "prefetch",
                                  tensor=tensor, after=tuple(after)))

    def store(self, tensor: str, name: Optional[str] = None,
              after: Sequence[str] = ()) -> Node:
        return self.add_node(Node(name or f"store::{tensor}", "store",
                                  tensor=tensor, after=tuple(after)))

    def detach(self, tensor: str, name: Optional[str] = None,
               after: Sequence[str] = ()) -> Node:
        return self.add_node(Node(name or f"detach::{tensor}", "detach",
                                  tensor=tensor, after=tuple(after)))

    # -- queries --------------------------------------------------------------
    def order(self) -> List[str]:
        return list(self.nodes)

    def producers(self) -> Dict[str, str]:
        """tensor -> producing compute/prefetch node (first writer)."""
        out: Dict[str, str] = {}
        for n in self.nodes.values():
            for t in n.writes():
                out.setdefault(t, n.name)
        return out

    def consumers(self) -> Dict[str, List[str]]:
        out: Dict[str, List[str]] = {t: [] for t in self.tensors}
        for n in self.nodes.values():
            for t in n.reads():
                out[t].append(n.name)
        return out

    def dependencies(self, order: Optional[Sequence[str]] = None) -> Dict[str, List[str]]:
        """node -> list of node names it depends on (data + cache-legality
        + explicit control deps). Cache-op data deps:

        - prefetch t: after the most recent ``store t`` (or none if t starts
          remote / is persistent with a standing remote copy);
        - store t: after t's producer (t must exist on device);
        - detach t: after the store of t (remote copy) and after every
          consumer of t that precedes the next prefetch — we conservatively
          require all reads of t *before this detach in program order*.
        """
        order = list(order) if order is not None else self.order()
        pos = {n: i for i, n in enumerate(order)}
        deps: Dict[str, List[str]] = {n: [] for n in order}

        produced_by: Dict[str, str] = {}
        last_store: Dict[str, str] = {}
        readers_so_far: Dict[str, List[str]] = {t: [] for t in self.tensors}

        for name in order:
            node = self.nodes[name]
            d: List[str] = list(node.after)
            if node.kind == "compute":
                for t in node.inputs:
                    # depend on the latest producing event of t before us
                    p = self._latest_writer(t, pos[name], order)
                    if p is not None:
                        d.append(p)
            elif node.kind == "store":
                p = self._latest_writer(node.tensor, pos[name], order)
                if p is not None:
                    d.append(p)
            elif node.kind == "prefetch":
                s = self._latest_event(node.tensor, pos[name], order, ("store",))
                if s is not None:
                    d.append(s)
            elif node.kind == "detach":
                t = node.tensor
                s = self._latest_event(t, pos[name], order, ("store",))
                if s is not None:
                    d.append(s)
                d.extend(readers_so_far[t])
            for t in node.reads():
                readers_so_far[t].append(name)
            deps[name] = sorted(set(d), key=lambda n: pos.get(n, -1))
        return deps

    def _latest_writer(self, tensor: str, before: int, order: Sequence[str]) -> Optional[str]:
        return self._latest_event(tensor, before, order, ("compute", "prefetch"))

    def _latest_event(self, tensor: str, before: int, order: Sequence[str],
                      kinds: Tuple[str, ...]) -> Optional[str]:
        for i in range(before - 1, -1, -1):
            n = self.nodes[order[i]]
            if n.kind not in kinds:
                continue
            if n.kind == "compute":
                if tensor in n.outputs:
                    return n.name
            elif n.tensor == tensor:
                return n.name
        return None

    # -- validation -----------------------------------------------------------
    def validate_order(self, order: Sequence[str]) -> None:
        """Raise if ``order`` is not a valid execution of this graph."""
        order = list(order)
        if sorted(order) != sorted(self.nodes):
            raise ValueError("order must be a permutation of all nodes")
        produced = {t for n in self.nodes.values() for t in n.writes()
                    if n.kind == "compute"}
        resident = {t: (info.initial_location == "device" and t not in produced)
                    for t, info in self.tensors.items()}
        remote = {t: (info.initial_location == "remote")
                  for t, info in self.tensors.items()}
        pos = {n: i for i, n in enumerate(order)}
        for name in order:
            node = self.nodes[name]
            for dep in node.after:
                if pos[dep] >= pos[name]:
                    raise ValueError(f"{name} before its control dep {dep}")
            if node.kind == "compute":
                for t in node.inputs:
                    if not resident[t]:
                        raise ValueError(f"{name} reads non-resident tensor {t}")
                for t in node.outputs:
                    resident[t] = True
            elif node.kind == "store":
                if not resident[node.tensor]:
                    raise ValueError(f"{name}: store of non-resident {node.tensor}")
                remote[node.tensor] = True
            elif node.kind == "prefetch":
                if not remote[node.tensor]:
                    raise ValueError(f"{name}: prefetch of {node.tensor} with no remote copy")
                resident[node.tensor] = True
            elif node.kind == "detach":
                if not resident[node.tensor]:
                    raise ValueError(f"{name}: detach of non-resident {node.tensor}")
                # future reads must be preceded by a prefetch — checked by the
                # compute-read rule as we continue the walk
                resident[node.tensor] = False

    def copy(self) -> "Graph":
        g = Graph()
        g.tensors = dict(self.tensors)
        g.nodes = {k: dataclasses.replace(v) for k, v in self.nodes.items()}
        return g

    def residentize(self) -> "Graph":
        """Everything-on-device baseline: all tensors start device-resident
        and cache operators are stripped (the paper's no-offload baseline)."""
        g = Graph()
        g.tensors = {
            t: dataclasses.replace(info, initial_location="device")
            for t, info in self.tensors.items()
        }
        g.nodes = {k: dataclasses.replace(v) for k, v in self.nodes.items()
                   if not v.is_cache_op}
        return g
