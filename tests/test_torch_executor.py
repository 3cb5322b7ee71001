"""The port's plan executors (``repro_torch.pool.executor``,
``repro_torch.core.torch_exec``) against the JAX package's, on the CPU.

The same graphs, planned by each package's planner under the same
``TPU_V5E`` numbers, run through each package's executor: the executed
residency trace equals ``core.memsim``'s prediction node for node and the
JAX executor's trace, the pool sees the same traffic, and the values equal
the everything-resident baseline's (and the JAX run's within fp32
rounding: 1e-5 absolute on tanh outputs of 64×64 products)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ir as jax_ir
from repro.core import memsim as jax_memsim
from repro.core.costmodel import TPU_V5E as JAX_TPU_V5E
from repro.core.jax_exec import PlanExecutor as JaxPlanExecutor
from repro.core.jax_exec import run_baseline as jax_run_baseline
from repro.core.planner import HyperOffloadPlanner as JaxPlanner
from repro.pool import OffloadPlanExecutor as JaxOffloadPlanExecutor
from repro.pool import default_pool as jax_default_pool
from repro_torch.core import ir as torch_ir
from repro_torch.core import memsim
from repro_torch.core.costmodel import TPU_V5E
from repro_torch.core.planner import HyperOffloadPlanner
from repro_torch.core.torch_exec import PlanExecutor, run_baseline
from repro_torch.pool import OffloadPlanExecutor, default_pool

def _small_graph(ir):
    """``tests/conftest.py``'s ``small_graph`` built with ``ir``: a 4-layer
    chain with remote weights and an offloadable activation gap."""
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


def _plans():
    return (JaxPlanner(JAX_TPU_V5E).plan(_small_graph(jax_ir)),
            HyperOffloadPlanner(TPU_V5E).plan(_small_graph(torch_ir)))


def _traffic(snap):
    return {k: snap[k] for k in ("puts", "gets", "evictions", "bytes_stored",
                                 "bytes_fetched")} | {
        "issued": snap["transfer"]["issued"],
        "pairs": {p: (d["transfers"], d["bytes"])
                  for p, d in snap["transfer"]["pairs"].items()}}


def test_executor_residency_matches_memsim_on_planned_graph():
    jplan, plan = _plans()
    assert plan.order == jplan.order
    predicted = memsim.simulate(plan.graph, plan.order)
    pool, jpool = default_pool(device="cpu"), jax_default_pool()
    env, trace = OffloadPlanExecutor(plan, pool).run()
    _, jtrace = JaxOffloadPlanExecutor(jplan, jpool).run()
    assert trace.usage == predicted.usage          # node-for-node agreement
    assert trace.peak_bytes == predicted.peak_bytes
    assert trace.matches(predicted)
    assert trace.usage == jtrace.usage
    assert (trace.peak_pos, trace.prefetches, trace.stores,
            trace.detaches) == (jtrace.peak_pos, jtrace.prefetches,
                                jtrace.stores, jtrace.detaches)
    assert predicted.usage == jax_memsim.simulate(jplan.graph,
                                                  jplan.order).usage
    assert trace.prefetches > 0                    # the plan really moved data
    snap = pool.snapshot()
    assert snap["bytes_fetched"] > 0 and snap["bytes_stored"] > 0
    assert snap["transfer"]["issued"] == trace.prefetches
    assert _traffic(snap) == _traffic(jpool.snapshot())
    # unbound computes materialize uint8 buffers of the declared size
    assert env["y"].dtype == torch.uint8 and env["y"].numel() == 1 << 20
    pool.close()
    jpool.close()


def _fns(graph, lib):
    """One callable per compute node: the sum of its inputs, broadcast
    into (8,) plus the output index (``lib`` is ``torch`` or ``jnp``)."""
    def fn(*args, _n=1):
        if lib is torch:
            s = sum(a.float().sum() for a in args)
            return tuple(torch.full((8,), 0.0) + s + i for i in range(_n))
        s = sum(jnp.sum(a.astype(jnp.float32)) for a in args)
        return tuple(jnp.full((8,), s) + i for i in range(_n))
    return {n: (lambda *a, _n=len(node.outputs): fn(*a, _n=_n))
            for n, node in graph.nodes.items() if node.kind == "compute"}


def test_executor_values_match_resident_baseline():
    jplan, plan = _plans()
    x = np.random.default_rng(7).standard_normal(16).astype(np.float32)
    inputs = {"x": torch.from_numpy(x)}
    jinputs = {"x": jnp.asarray(x)}
    for i in range(4):
        inputs[f"w{i}"] = torch.full((8,), float(i + 1))
        jinputs[f"w{i}"] = jnp.full((8,), float(i + 1))
    pool = default_pool(device="cpu")
    env, trace = OffloadPlanExecutor(
        plan, pool, _fns(plan.graph, torch)).run(inputs)
    ref = run_baseline(_small_graph(torch_ir), _fns(plan.graph, torch),
                       inputs, device="cpu")
    torch.testing.assert_close(env["y"], ref["y"], rtol=1e-6, atol=0)
    assert trace.stores >= 1 and trace.detaches >= 1
    jenv, jtrace = JaxOffloadPlanExecutor(
        jplan, jax_default_pool(), _fns(jplan.graph, jnp)).run(jinputs)
    np.testing.assert_allclose(env["y"].numpy(), np.asarray(jenv["y"]),
                               rtol=1e-6)
    assert trace.usage == jtrace.usage
    pool.close()


def test_executor_rejects_invalid_order():
    jplan, plan = _plans()
    bad = list(reversed(plan.order))
    with pytest.raises(ValueError) as te:
        OffloadPlanExecutor(plan, default_pool(device="cpu")).run(order=bad)
    with pytest.raises(ValueError) as je:
        JaxOffloadPlanExecutor(jplan, jax_default_pool()).run(
            order=list(reversed(jplan.order)))
    assert str(te.value) == str(je.value)


def _chain(ir, D=64):
    g = ir.Graph()
    g.add_tensor("x", D * D * 4)
    prev = "x"
    for i in range(5):
        g.add_tensor(f"w{i}", 64 << 20, "weight", "remote")
        g.add_tensor(f"h{i}", D * D * 4)
        g.compute(f"f{i}", inputs=(prev, f"w{i}"), outputs=(f"h{i}",),
                  flops=1e12, hbm_bytes=1e6)
        prev = f"h{i}"
    return g


def test_plan_executor_equivalence_with_offload():
    """``tests/test_substrates.py``'s chain: 5 layers of tanh(x @ w) with
    remote weights. Through the planner's cache ops the port's values equal
    its resident baseline's, and the JAX executor's on the same inputs."""
    D = 64
    rng = np.random.default_rng(9)
    ws = [0.1 * rng.standard_normal((D, D)).astype(np.float32)
          for _ in range(5)]
    x = rng.standard_normal((D, D)).astype(np.float32)
    fns = {f"f{i}": (lambda a, w: (torch.tanh(a @ w[:D, :D]),))
           for i in range(5)}
    jfns = {f"f{i}": (lambda a, w: (jnp.tanh(a @ w[:D, :D]),))
            for i in range(5)}
    inputs = {"x": torch.from_numpy(x)} | {
        f"w{i}": torch.from_numpy(w) for i, w in enumerate(ws)}
    jinputs = {"x": jnp.asarray(x)} | {
        f"w{i}": jnp.asarray(w) for i, w in enumerate(ws)}

    g = _chain(torch_ir, D)
    plan = HyperOffloadPlanner(TPU_V5E).plan(g)
    jplan = JaxPlanner(JAX_TPU_V5E).plan(_chain(jax_ir, D))
    assert any(n.kind == "prefetch" for n in plan.graph.nodes.values())
    assert plan.order == jplan.order
    pool = default_pool(device="cpu")
    out = PlanExecutor(plan.graph, fns, pool=pool).run(inputs, plan.order)
    ref = run_baseline(g, fns, inputs, device="cpu")
    torch.testing.assert_close(out["h4"], ref["h4"], atol=1e-6, rtol=0)
    snap = pool.snapshot()
    assert snap["puts"] >= 5 and snap["bytes_fetched"] > 0
    assert snap["transfer"]["issued"] > 0     # prefetches went async
    # a run leaves nothing behind in an injected pool
    assert snap["tier/host"]["entries"] == 0
    jpool = jax_default_pool()
    jout = JaxPlanExecutor(jplan.graph, jfns, pool=jpool).run(
        jinputs, jplan.order)
    np.testing.assert_allclose(out["h4"].numpy(), np.asarray(jout["h4"]),
                               atol=1e-5)
    assert _traffic(snap) == _traffic(jpool.snapshot())
    jref = jax_run_baseline(_chain(jax_ir, D), jfns, jinputs)
    np.testing.assert_allclose(ref["h4"].numpy(), np.asarray(jref["h4"]),
                               atol=1e-5)
    pool.close()
    jpool.close()


def test_plan_executor_rejects_missing_fn():
    msgs = []
    for ir, cls in ((torch_ir, PlanExecutor), (jax_ir, JaxPlanExecutor)):
        g = ir.Graph()
        g.add_tensor("a", 8)
        g.compute("f", outputs=("a",))
        with pytest.raises(ValueError, match="no compute fn") as e:
            cls(g, {})
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_plan_executor_without_a_pool_needs_cuda():
    """Without a pool or a device the executor builds its pool on CUDA,
    which this machine lacks: it raises instead of running on the CPU."""
    g = torch_ir.Graph()
    g.add_tensor("a", 8)
    g.compute("f", outputs=("a",))
    ex = PlanExecutor(g, {"f": lambda: torch.zeros(8)})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ex.run({})
    out = PlanExecutor(g, {"f": lambda: torch.zeros(8)},
                       device="cpu").run({})
    assert torch.equal(out["a"], torch.zeros(8))
