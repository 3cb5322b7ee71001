"""The port's planner core (``repro_torch.core``) against the JAX package's
(``repro.core``): the same graphs, planned under the same ``HardwareSpec``
numbers, give the same plan — the refined order, the inserted cache ops
with their slots and leads, the memory simulator's peak and the timeline's
makespan (floats within rel 1e-12: both sides run the same Python
arithmetic). The port's H100 spec plans the serving decode graph without
error, and its plan is valid."""

import dataclasses

import pytest

from repro.configs import REGISTRY as JAX_REGISTRY
from repro.core import costmodel as jax_cost
from repro.core import insertion as jax_ins
from repro.core import ir as jax_ir
from repro.core import planner as jax_planner
from repro.core import tracer as jax_tracer
from repro_torch.configs import REGISTRY as TORCH_REGISTRY
from repro_torch.core import costmodel as torch_cost
from repro_torch.core import insertion as torch_ins
from repro_torch.core import ir as torch_ir
from repro_torch.core import planner as torch_planner
from repro_torch.core import tracer as torch_tracer
from repro_torch.sched.prefetch import PlanPrefetcher

JAX = (jax_ir, jax_cost, jax_ins, jax_planner, jax_tracer, JAX_REGISTRY)
TORCH = (torch_ir, torch_cost, torch_ins, torch_planner, torch_tracer,
         TORCH_REGISTRY)


def _small_graph(ir):
    """A 4-layer chain with remote weights and an offloadable activation
    gap (``tests/conftest.py``'s ``small_graph``), built with ``ir``."""
    g = ir.Graph()
    g.add_tensor("x", 1 << 20)
    prev = "x"
    for i in range(4):
        g.add_tensor(f"w{i}", 64 << 20, "weight", "remote")
        g.add_tensor(f"h{i}", 1 << 20)
        g.compute(f"f{i}", inputs=(prev, f"w{i}"), outputs=(f"h{i}",),
                  flops=5e11, hbm_bytes=1e6)
        prev = f"h{i}"
    g.add_tensor("skip", 128 << 20)
    g.nodes["f0"].outputs = ("h0", "skip")
    g.add_tensor("y", 1 << 20)
    g.compute("tail", inputs=("h3", "skip"), outputs=("y",),
              flops=5e11, hbm_bytes=1e6)
    return g


def _graph(pkg, name):
    ir, _, _, _, tracer, registry = pkg
    if name == "small":
        return _small_graph(ir)
    arch, batch, seq = {"phi3": ("phi3-mini-3.8b", 2, 32),
                        "gemma2": ("gemma2-9b", 2, 32)}[name]
    return tracer.trace_decode_step(registry[arch].reduced(), batch, seq,
                                    tracer.TraceOptions(remote_kv=True))


def _plan(pkg, name, refine):
    _, cost, ins, planner, _, _ = pkg
    opts = ins.InsertionOptions() if name == "small" else ins.PAGED_INSERTION
    return planner.HyperOffloadPlanner(cost.TPU_V5E, insert_opts=opts).plan(
        _graph(pkg, name), refine=refine)


def _cache_ops(plan):
    """(name, kind, tensor, slot, lead) of every cache op in plan order;
    a prefetch's lead is the slots until the first compute that reads its
    tensor."""
    pos = {n: i for i, n in enumerate(plan.order)}
    out = []
    for name in plan.order:
        node = plan.graph.nodes[name]
        if not node.is_cache_op:
            continue
        lead = None
        if node.kind == "prefetch":
            lead = min(pos[c] for c, n in plan.graph.nodes.items()
                       if n.kind == "compute" and node.tensor in n.inputs
                       and pos[c] > pos[name]) - pos[name]
        out.append((name, node.kind, node.tensor, pos[name], lead))
    return out


def _tensors(graph):
    return {t: dataclasses.astuple(i) for t, i in graph.tensors.items()}


def _nodes(graph):
    return [(n.name, n.kind, n.inputs, n.outputs, n.flops, n.hbm_bytes,
             n.tensor, n.after) for n in graph.nodes.values()]


def test_specs_and_options_match_the_reference():
    for name in ("TPU_V5E", "ASCEND_LIKE"):
        assert dataclasses.asdict(getattr(torch_cost, name)) == \
            dataclasses.asdict(getattr(jax_cost, name))
    assert dataclasses.asdict(torch_ins.PAGED_INSERTION) == \
        dataclasses.asdict(jax_ins.PAGED_INSERTION)


@pytest.mark.parametrize("name", ["small", "phi3", "gemma2"])
def test_traced_graphs_match_the_reference(name):
    jg, tg = _graph(JAX, name), _graph(TORCH, name)
    assert _tensors(tg) == _tensors(jg)
    assert _nodes(tg) == _nodes(jg)


@pytest.mark.parametrize("refine", [True, False])
@pytest.mark.parametrize("name", ["small", "phi3", "gemma2"])
def test_plan_matches_the_reference(name, refine):
    jp, tp = _plan(JAX, name, refine), _plan(TORCH, name, refine)
    assert tp.order == jp.order
    ops = _cache_ops(tp)
    assert ops == _cache_ops(jp)
    assert any(kind == "prefetch" for _, kind, _, _, _ in ops)
    assert _nodes(tp.graph) == _nodes(jp.graph)
    assert _tensors(tp.graph) == _tensors(jp.graph)
    for attr in ("memory", "base_memory", "naive_memory"):
        t, j = getattr(tp, attr), getattr(jp, attr)
        assert (t.peak_bytes, t.peak_pos, t.usage) == \
            (j.peak_bytes, j.peak_pos, j.usage)
    for attr in ("timeline", "base_timeline", "naive_timeline"):
        t, j = getattr(tp, attr), getattr(jp, attr)
        assert t.total == pytest.approx(j.total, rel=1e-12)
        assert t.exposed_comm == pytest.approx(j.exposed_comm, rel=1e-12,
                                               abs=1e-15)
        assert set(t.schedule) == set(j.schedule)
    assert tp.summary() == pytest.approx(jp.summary(), rel=1e-12, abs=1e-15)


@pytest.mark.parametrize("arch,batch,max_seq", [
    ("phi3-mini-3.8b", 2, 32),         # reduced, as the CPU parity runs
    ("gemma2-9b", 2, 32),
    ("phi3-mini-3.8b", 4, 576),        # full width, the card's sched phase
])
def test_h100_spec_plans_a_valid_prefetch_order(arch, batch, max_seq):
    """Under ``H100`` (the port's default) every layer's KV prefetch lands
    before its consumer: the refined order is a valid execution of the
    graph, and the prefetcher's plan leads are all positive."""
    cfg = TORCH_REGISTRY[arch]
    if max_seq == 32:
        cfg = cfg.reduced()
    g = torch_tracer.trace_decode_step(cfg, batch, max_seq,
                                       torch_tracer.TraceOptions(
                                           remote_kv=True))
    plan = torch_planner.HyperOffloadPlanner(
        torch_cost.H100, insert_opts=torch_ins.PAGED_INSERTION).plan(g)
    plan.graph.validate_order(plan.order)
    ops = _cache_ops(plan)
    prefetched = {t for _, kind, t, _, _ in ops if kind == "prefetch"}
    assert prefetched == {f"kv_{i}" for i in range(cfg.n_layers)}
    assert all(lead >= 1 for _, kind, _, _, lead in ops if kind == "prefetch")
    assert plan.timeline.total > 0 and plan.memory.peak_bytes > 0

    class _Pool:   # the plan needs no pool until it issues
        topology = None

    pf = PlanPrefetcher(cfg, batch, max_seq, pool=_Pool())
    assert sorted(pf.issue_order) == list(range(cfg.n_layers))
    assert sorted(pf.consumption_order) == list(range(cfg.n_layers))
    assert min(pf.stats.plan_leads.values()) >= 1
    assert pf.stats.mean_plan_lead >= 1.0
