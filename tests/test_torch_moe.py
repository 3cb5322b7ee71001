"""The port's MoE FFN (``repro_torch.models.moe``) and MLA layer against the
JAX package's, on the CPU in fp32, and the configs of the port's later
slices.

Inputs come from numpy with a seed; the JAX parameters are carried across
with ``repro_torch.convert``. ``moe_ffn`` runs at granite-moe-3b-a800m's
routing shape (40 experts, top-8) on narrow widths (``d_model`` 64,
``d_ff_expert`` 32): the reduced configs cut MoE to 4 experts and top-2,
so they never test top-8 of 40. Tolerances:

- the router's decisions (the kept-assignment mask and ``dest``, the
  buffer row of each expert-sorted assignment) are equal;
- ``moe_ffn``'s output at atol 1e-5 and its aux loss at rtol 1e-6, the
  MLA layer's output (values up to ~20) at atol 1e-4 (fp32 sums in
  another order);
- gradients at rtol 1e-4, atol 1e-6, as the training tests hold them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as JAX_REGISTRY
from repro.models import blocks as jax_blocks
from repro.models import moe as jax_moe
from repro_torch.configs import REGISTRY as TORCH_REGISTRY
from repro_torch.convert import params_from_numpy
from repro_torch.models import blocks as torch_blocks
from repro_torch.models import moe as torch_moe
from repro_torch.models.model import build_model

CPU = torch.device("cpu")
GRANITE = "granite-moe-3b-a800m"


def _granite_routing(registry, capacity_factor):
    cfg = registry[GRANITE]
    return dataclasses.replace(
        cfg.reduced(), d_model=64,
        moe=dataclasses.replace(cfg.moe, d_ff_expert=32,
                                capacity_factor=capacity_factor))


class _RecordWhere:
    """Stands in for ``jnp`` inside ``repro.models.moe`` and records the
    arguments of its one ``jnp.where``: ``dest = where(keep, se * cap +
    rank, e * cap)``."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def where(self, *args):
        self.calls.append(args)
        return jnp.where(*args)


def _moe_pair(capacity_factor, seed=0):
    jc = _granite_routing(JAX_REGISTRY, capacity_factor)
    tc = _granite_routing(TORCH_REGISTRY, capacity_factor)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert (tc.moe.n_experts, tc.moe.top_k) == (40, 8)
    jp = jax_moe.init_moe_params(jc, jax.random.key(seed), jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), CPU)
    x = np.random.default_rng(seed).standard_normal(
        (2, 24, tc.d_model)).astype(np.float32)
    return jc, jp, tc, tp, x


@pytest.mark.parametrize("capacity_factor,drops", [(0.3, True),
                                                   (1.25, None),
                                                   (4.0, False)])
def test_moe_ffn_routes_and_combines_as_the_reference(monkeypatch,
                                                      capacity_factor, drops):
    jc, jp, tc, tp, x = _moe_pair(capacity_factor)
    rec = _RecordWhere()
    monkeypatch.setattr(jax_moe, "jnp", rec)
    jout, jaux = jax_moe.moe_ffn(jc, jp, jnp.asarray(x))
    monkeypatch.undo()
    (jkeep, jdest_kept, _), = rec.calls
    jkeep = np.asarray(jkeep)
    jdest = np.where(jkeep, np.asarray(jdest_kept),
                     tc.moe.n_experts * torch_moe.expert_capacity(48, tc))

    xt = torch.from_numpy(x)
    r = torch_moe.route(tc, tp["router"], xt.reshape(48, tc.d_model))
    assert r.capacity == torch_moe.expert_capacity(48, tc) == \
        jax_moe.expert_capacity(48, jc)
    np.testing.assert_array_equal(r.keep.numpy(), jkeep)
    np.testing.assert_array_equal(r.dest.numpy(), jdest)
    if drops is not None:
        assert bool((~r.keep).any()) == drops

    out, aux = torch_moe.moe_ffn(tc, tp, xt)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)


def test_a_dropped_assignment_contributes_exactly_zero():
    """With capacity 0.3 most assignments drop: each token's output is the
    weighted sum of its kept experts' outputs alone, bit for bit."""
    _, _, tc, tp, x = _moe_pair(0.3)
    xf = torch.from_numpy(x).reshape(48, tc.d_model)
    r = torch_moe.route(tc, tp["router"], xf)
    out, _ = torch_moe.moe_ffn(tc, tp, torch.from_numpy(x))
    out = out.reshape(48, tc.d_model)
    cap, k = r.capacity, tc.moe.top_k
    kept = r.token_dest < tc.moe.n_experts * cap
    assert 0 < int(kept.sum()) < 48 * k
    for t in range(48):
        want = torch.zeros(tc.d_model)
        for i in range(k):
            if not kept[t, i]:
                continue
            e = int(r.token_dest[t, i]) // cap
            h = torch.nn.functional.silu(xf[t] @ tp["w_gate"][e]) * \
                (xf[t] @ tp["w_up"][e])
            want = want + (h @ tp["w_down"][e]) * r.token_w[t, i]
        torch.testing.assert_close(out[t], want, rtol=1e-6, atol=1e-6)
    # a token whose every assignment dropped gives exactly zero
    none_kept = ~kept.any(dim=1)
    assert torch.equal(out[none_kept], torch.zeros_like(out[none_kept]))


def test_topk_ties_go_to_the_lower_expert_index():
    """Equal router probabilities: the port picks the lower expert index,
    as ``jax.lax.top_k`` does."""
    _, _, tc, tp, _ = _moe_pair(1.25)
    router = torch.zeros_like(tp["router"])
    r = torch_moe.route(tc, router, torch.ones(3, tc.d_model))
    assert r.top_e.tolist() == [list(range(8))] * 3
    jtop = jax.lax.top_k(jnp.full((3, 40), 0.025), 8)[1]
    np.testing.assert_array_equal(r.top_e.numpy(), np.asarray(jtop))


def test_moe_ffn_gradients_match_jax():
    jc, jp, tc, tp, x = _moe_pair(1.25, seed=1)
    w = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)

    def jloss(p, x):
        out, aux = jax_moe.moe_ffn(jc, p, x)
        return jnp.sum(out * w) + aux

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = torch_moe.moe_ffn(tc, tp, xt)
    (torch.sum(out * torch.from_numpy(w)) + aux).backward()
    for name in tp:
        np.testing.assert_allclose(tp[name].grad.numpy(),
                                   np.asarray(jg[name]), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=1e-4,
                               atol=1e-6)


def test_an_mla_layer_and_its_gradients_match_jax():
    """One minicpm3 layer (MLA mixer, SwiGLU FFN) of the reduced config:
    the output, then the gradients of every parameter and of the input."""
    jc = JAX_REGISTRY["minicpm3-4b"].reduced()
    tc = TORCH_REGISTRY["minicpm3-4b"].reduced()
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    spec_j, spec_t = jc.segments[0].pattern[0], tc.segments[0].pattern[0]
    jp = jax_blocks.init_layer_params(jc, spec_j, jax.random.key(3),
                                      jnp.float32)
    rng = np.random.default_rng(3)
    # nonzero norm scales, so their gradients are tested at a general point
    jp = jax.tree.map(lambda a: a + 0.1 * rng.standard_normal(a.shape)
                      .astype(np.float32) if a.ndim == 1 else a, jp)
    x = rng.standard_normal((2, 12, tc.d_model)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))

    def jloss(p, x):
        out, _ = jax_blocks.apply_layer(jc, spec_j, p, x, jnp.asarray(pos))
        return jnp.mean(out * w), out

    (_, jout), (jg, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), CPU)
    leaves = []

    def req(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                req(v)
            else:
                leaves.append(v.requires_grad_(True))
    req(tp)
    xt = torch.from_numpy(x).requires_grad_(True)
    out, _ = torch_blocks.apply_layer(tc, spec_t, tp, xt,
                                      torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-4, rtol=0)
    torch.mean(out * torch.from_numpy(w)).backward()
    assert sorted(tp["mixer"]) == sorted(jg["mixer"])
    for part in ("mixer", "ffn"):
        for name in tp[part]:
            np.testing.assert_allclose(
                tp[part][name].grad.numpy(), np.asarray(jg[part][name]),
                rtol=1e-4, atol=1e-6, err_msg=f"{part}/{name}")
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=1e-4,
                               atol=1e-6)


def test_mla_above_the_chunk_threshold_matches_jax():
    """A 2100-token MLA prefill takes the query-chunked path (chunks of
    ``CHUNK_Q`` above ``CHUNKED_ATTN_THRESHOLD``, the last one partial) in
    both packages: the outputs agree at atol 1e-4."""
    from repro.models import attention as jax_attn
    from repro_torch.models import attention as torch_attn
    jc = JAX_REGISTRY["minicpm3-4b"].reduced()
    tc = TORCH_REGISTRY["minicpm3-4b"].reduced()
    s = 2100
    assert s > torch_attn.CHUNKED_ATTN_THRESHOLD == \
        jax_attn.CHUNKED_ATTN_THRESHOLD
    jp = jax_attn.init_mla_params(jc, jax.random.key(4), jnp.float32)
    x = np.random.default_rng(4).standard_normal(
        (1, s, tc.d_model)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)[None]
    jout = jax.jit(lambda p, x: jax_attn._mla_full(jc, p, x, pos))(
        jp, jnp.asarray(x))
    tout = torch_attn._mla_full(tc, params_from_numpy(
        jax.tree.map(np.asarray, jp), CPU), torch.from_numpy(x),
        torch.from_numpy(pos))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-4,
                               rtol=0)


# ---------------------------------------------------------------------------
# parameter trees: types, and the round trip through convert
# ---------------------------------------------------------------------------


def _tree_items(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_items(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tree_items(v, path + (i,))
    else:
        yield path, tree


@pytest.mark.parametrize("arch", [GRANITE, "minicpm3-4b"])
def test_moe_and_mla_trees_keep_their_types_both_ways(arch):
    """A bf16 JAX tree carried across keeps every leaf's shape, type and
    bits (the router and MLA's norms stay fp32), the port's own bf16
    initialisation builds the same tree, shapes and types, and the
    converted tree runs the port's forward."""
    from repro.models.model import build_model as jax_build_model
    jm = jax_build_model(JAX_REGISTRY[arch].reduced())
    tm = build_model(TORCH_REGISTRY[arch].reduced())
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(0), jnp.bfloat16))
    tp = params_from_numpy(jp, CPU)
    own = tm.init(torch.Generator().manual_seed(0), torch.bfloat16, CPU)
    jit, tit, oit = (list(_tree_items(t)) for t in (jp, tp, own))
    assert [p for p, _ in jit] == [p for p, _ in tit] == [p for p, _ in oit]
    for (path, a), (_, t), (_, o) in zip(jit, tit, oit):
        assert tuple(t.shape) == a.shape == tuple(o.shape), path
        assert t.dtype == o.dtype, path
        want = torch.float32 if a.dtype == np.float32 else torch.bfloat16
        assert t.dtype == want, path
        np.testing.assert_array_equal(t.float().numpy(),
                                      a.astype(np.float32))
    f32 = {p for p, t in tit if t.dtype == torch.float32}
    if arch == GRANITE:
        assert ("segments", 0, "p0", "ffn", "router") in f32
    else:
        assert {("segments", 0, "p0", "mixer", "q_norm"),
                ("segments", 0, "p0", "mixer", "kv_norm")} <= f32
    toks = torch.zeros((1, 4), dtype=torch.int64)
    logits, aux = tm.forward(tp, {"tokens": toks})
    assert torch.isfinite(logits).all() and torch.isfinite(aux)


# ---------------------------------------------------------------------------
# the configs of the port's later slices
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", GRANITE, "mixtral-8x22b",
                                  "minicpm3-4b", "whisper-medium",
                                  "qwen2-vl-72b"])
def test_the_new_configs_are_supported_at_full_size_and_reduced(arch):
    cfg = TORCH_REGISTRY[arch]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(JAX_REGISTRY[arch])
    assert dataclasses.asdict(cfg.reduced()) == \
        dataclasses.asdict(JAX_REGISTRY[arch].reduced())
    torch_blocks.check_supported(cfg)
    torch_blocks.check_supported(cfg.reduced())


# ---------------------------------------------------------------------------
# _moe_ffn_sharded: the dispatch per data shard under a mesh
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def one_device_mesh():
    """A 1×1 ("data", "model") mesh on a single-rank gloo group, destroyed
    when the module's tests are done."""
    from repro_torch.launch.mesh import close_mesh, make_debug_mesh
    mesh = make_debug_mesh((1, 1), device="cpu")
    try:
        yield mesh
    finally:
        close_mesh()


@pytest.mark.parametrize("capacity_factor", [0.3, 4.0])
def test_moe_ffn_sharded_on_one_device_is_moe_ffn_bit_for_bit(
        one_device_mesh, capacity_factor):
    """Under a 1×1 mesh and the default rules ``moe_ffn`` takes
    ``_moe_ffn_sharded`` (the parameters placed as the launcher places
    them): out and aux equal the local path's bit for bit, dropping (0.3)
    and lossless (4.0)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.shardings import param_shardings, place
    from repro_torch.sharding.rules import DEFAULT_RULES, axis_rules
    _, _, tc, tp, x = _moe_pair(capacity_factor)
    xt = torch.from_numpy(x)
    want_out, want_aux = torch_moe.moe_ffn(tc, tp, xt)
    tree = {"ffn": tp}
    placed = place(tree, param_shardings(tree, one_device_mesh,
                                         DEFAULT_RULES), one_device_mesh)
    called = []
    orig = torch_moe._moe_ffn_sharded

    def spy(*a, **k):
        called.append(1)
        return orig(*a, **k)
    torch_moe._moe_ffn_sharded = spy
    try:
        with axis_rules(DEFAULT_RULES, one_device_mesh):
            out, aux = torch_moe.moe_ffn(tc, placed["ffn"], xt)
    finally:
        torch_moe._moe_ffn_sharded = orig
    assert called == [1]
    assert isinstance(out, DTensor)
    assert torch.equal(out.full_tensor(), want_out)
    assert torch.equal(aux.full_tensor(), want_aux)


_RANK = """
import sys, dataclasses
import numpy as np, torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.configs import REGISTRY
from repro_torch.launch.shardings import param_shardings, place
from repro_torch.models import moe
from repro_torch.sharding.rules import DEFAULT_RULES, axis_rules

rank, d = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"file://{d}/store", rank=rank,
                        world_size=4)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
data = np.load(f"{d}/in.npz")
base = REGISTRY["granite-moe-3b-a800m"].reduced()
out = {}
for cf in (0.3, 4.0):
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, capacity_factor=cf))
    tree = {"ffn": {k: torch.from_numpy(data[f"{cf}/{k}"])
                    for k in ("router", "w_gate", "w_up", "w_down")}}
    p = place(tree, param_shardings(tree, mesh, DEFAULT_RULES), mesh)["ffn"]
    x = distribute_tensor(torch.from_numpy(data[f"{cf}/x"]), mesh,
                          [Shard(0), Replicate()])
    with axis_rules(DEFAULT_RULES, mesh):
        o, aux = moe.moe_ffn(cfg, p, x)
    out[f"{cf}/out"] = o.full_tensor().numpy()
    out[f"{cf}/aux"] = aux.full_tensor().numpy()
    out[f"{cf}/placements"] = np.array(str(o.placements))
if rank == 0:
    np.savez(f"{d}/out.npz", **out)
dist.destroy_process_group()
"""


def test_moe_ffn_sharded_on_four_ranks_matches_the_per_shard_reference(
        tmp_path):
    """granite ``.reduced()`` (4 experts, top-2) on a 4-rank gloo group,
    2 data × 2 tensor-parallel ranks, one spawn for both cases (dropping
    0.3, lossless 4.0). The reference is what ``shard_map`` runs: each
    data shard's rows through ``repro.models.moe._moe_ffn_local``, the
    outputs concatenated and the aux losses averaged. fp32: out at atol
    1e-5 (only the tensor-parallel sum reassociates), aux at rtol 1e-6."""
    import os
    import subprocess
    import sys
    base = JAX_REGISTRY[GRANITE].reduced()
    inputs, want = {}, {}
    for cf in (0.3, 4.0):
        jc = dataclasses.replace(base, moe=dataclasses.replace(
            base.moe, capacity_factor=cf))
        jp = jax_moe.init_moe_params(jc, jax.random.key(7), jnp.float32)
        x = np.random.default_rng(8).standard_normal(
            (4, 16, jc.d_model)).astype(np.float32)
        for k, v in jp.items():
            inputs[f"{cf}/{k}"] = np.asarray(v)
        inputs[f"{cf}/x"] = x
        shards = [jax_moe._moe_ffn_local(jc, jp, jnp.asarray(x[i:i + 2]))
                  for i in (0, 2)]
        want[cf] = (np.concatenate([np.asarray(o) for o, _ in shards]),
                    np.mean([float(a) for _, a in shards]))
    np.savez(tmp_path / "in.npz", **inputs)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": os.path.join(repo, "src")}
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r),
                               str(tmp_path)], env=env, cwd=repo,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(4)]
    errs = [p.communicate(timeout=240)[1] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(errs)
    got = np.load(tmp_path / "out.npz")
    for cf, (out, aux) in want.items():
        np.testing.assert_allclose(got[f"{cf}/out"], out, atol=1e-5, rtol=0)
        np.testing.assert_allclose(got[f"{cf}/aux"], aux, rtol=1e-6)
        # out split by rows over "data", replicated over "model"
        assert str(got[f"{cf}/placements"]) == "(Shard(dim=0), Replicate())"
    # the dropping case drops: its outputs differ from the lossless one's
    assert np.abs(got["0.3/out"] - got["4.0/out"]).max() > 1e-3
