"""The port's sharding rules and launch-layer shardings
(``repro_torch.sharding``, ``repro_torch.launch.shardings``) against the
JAX package's, on the CPU.

The spec arithmetic reads only a mesh's axis names and sizes, so a
stand-in object with the reference mesh's ``axis_names`` and
``devices.shape`` serves both packages, and no 256 devices are needed:

- every param leaf of every ``REGISTRY`` config on 16×16 and 2×16×16 gets
  the reference's spec (``repro.launch.shardings._spec_for`` through
  ``jax.tree_util.tree_map_with_path`` on ``Model.param_specs``), and so
  does every cache and batch leaf at each ``INPUT_SHAPES`` entry under
  the dry-run's rules for that shape; equal as tuples;
- per-device argument bytes reckoned from the reference's specs equal the
  port's dry-run record's (``lower_one(compile_=False)``, which starts
  the fake process group and destroys it);
- ``to_placements`` and ``place`` on a fake 2×16×16 ``DeviceMesh``:
  ("pod", "data") splits one dim over both mesh dims, major to minor.
  Every test that starts a process group destroys it before it ends.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import INPUT_SHAPES, REGISTRY as JAX_REGISTRY
from repro.launch import shardings as jsh
from repro.models.model import build_model as jax_build_model
from repro.sharding import rules as jrules
from repro_torch.configs import REGISTRY as TORCH_REGISTRY
from repro_torch.launch import shardings as tsh
from repro_torch.models.model import build_model as torch_build_model
from repro_torch.optim.adamw import tree_items
from repro_torch.sharding import rules as trules

ARCHS = sorted(JAX_REGISTRY)
MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}


def stand_in(name):
    axes, shape = MESHES[name]
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))


def _ref_rules_for():
    """The reference dry-run's ``_rules_for``. Its module sets XLA_FLAGS on
    import (512 host devices, read when JAX first starts a backend), so
    the environment is put back right after the import."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import _rules_for
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return _rules_for


def _ref_specs(tree, table, rules, mesh):
    """(path-free) specs of the reference's leaves in its tree order."""
    specs = jax.tree_util.tree_map_with_path(
        lambda p, l: jsh._spec_for(p, l, table, rules, mesh), tree)
    return [tuple(s) for s in jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]


def _port_specs(tree, table, rules, mesh):
    return [tsh._spec_for(p, l, table, rules, mesh)
            for p, l in tree_items(tree)]


def _mesh_rules(name):
    return dict(trules.MULTIPOD_RULES if name == "2x16x16"
                else trules.DEFAULT_RULES)


def test_rule_tables_are_the_reference_s():
    assert trules.DEFAULT_RULES == jrules.DEFAULT_RULES
    assert trules.MULTIPOD_RULES == jrules.MULTIPOD_RULES
    for name in ("PARAM_LOGICAL", "MOE_LOGICAL", "CACHE_LOGICAL",
                 "BATCH_LOGICAL"):
        assert getattr(tsh, name) == getattr(jsh, name), name


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_the_reference(arch, mesh_name):
    mesh = stand_in(mesh_name)
    rules = _mesh_rules(mesh_name)
    jp = jax_build_model(JAX_REGISTRY[arch]).param_specs(jnp.bfloat16)
    tp = torch_build_model(TORCH_REGISTRY[arch]).param_specs(torch.bfloat16)
    # shapes, dtypes and leaf order first, then the specs
    jl = jax.tree.leaves(jp)
    tl = [l for _, l in tree_items(tp)]
    assert [tuple(a.shape) for a in jl] == [tuple(t.shape) for t in tl]
    assert [str(a.dtype) for a in jl] == \
        [str(t.dtype).replace("torch.", "") for t in tl]
    assert all(t.device.type == "meta" for t in tl)
    ref = _ref_specs(jp, jsh.PARAM_LOGICAL, rules, mesh)
    assert ref == _port_specs(tp, tsh.PARAM_LOGICAL, rules, mesh)
    # something is sharded: the tables are not all dropped
    assert any(any(p is not None for p in s) for s in ref)


@pytest.mark.parametrize("shape", sorted(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_specs_match_the_reference(arch, shape):
    """Every cache and batch leaf at one ``INPUT_SHAPES`` entry, on both
    meshes, under the dry-run's rules for that shape (``cache_seq`` where
    the kv heads do not divide the model axis; ``seq_act`` for train and
    prefill); the rules themselves are the reference's too."""
    from repro_torch.launch.dryrun import _rules_for
    ref_rules_for = _ref_rules_for()
    ishape = INPUT_SHAPES[shape]
    jm = jax_build_model(JAX_REGISTRY[arch], ishape)
    tm = torch_build_model(TORCH_REGISTRY[arch], ishape)
    b, s = ishape.global_batch, ishape.seq_len
    jc = jm.cache_specs(b, s, jnp.bfloat16)
    tc = tm.cache_specs(b, s, torch.bfloat16)
    jb = jm.input_specs(ishape, jnp.bfloat16)
    tb = tm.input_specs(ishape, torch.bfloat16)
    assert [tuple(a.shape) for a in jax.tree.leaves(jb)] == \
        [tuple(t.shape) for _, t in tree_items(tb)]
    for mesh_name in MESHES:
        mesh = stand_in(mesh_name)
        rules = ref_rules_for(JAX_REGISTRY[arch], ishape, mesh)
        assert _rules_for(TORCH_REGISTRY[arch], ishape, mesh) == rules
        assert _ref_specs(jc, jsh.CACHE_LOGICAL, rules, mesh) == \
            _port_specs(tc, tsh.CACHE_LOGICAL, rules, mesh)
        assert _ref_specs(jb, jsh.BATCH_LOGICAL, rules, mesh) == \
            _port_specs(tb, tsh.BATCH_LOGICAL, rules, mesh)


def test_make_batch_specs_match_the_reference():
    from repro.data.pipeline import make_batch_specs as jspecs
    from repro_torch.data.pipeline import make_batch_specs as tspecs
    for arch in ARCHS:
        j = jspecs(JAX_REGISTRY[arch], 64, 4, jnp.bfloat16)
        t = tspecs(TORCH_REGISTRY[arch], 64, 4, torch.bfloat16)
        assert sorted(j) == sorted(t)
        for k in j:
            assert tuple(j[k].shape) == tuple(t[k].shape), (arch, k)
            assert str(j[k].dtype) == str(t[k].dtype).replace(
                "torch.", ""), (arch, k)
            assert t[k].device.type == "meta"


def test_mixtral_param_specs_allocate_nothing():
    """mixtral-8x22b's ~282 GB of bf16 parameters, as meta tensors."""
    cfg = TORCH_REGISTRY["mixtral-8x22b"]
    specs = torch_build_model(cfg).param_specs(torch.bfloat16)
    leaves = [l for _, l in tree_items(specs)]
    assert all(l.device.type == "meta" for l in leaves)
    n = sum(l.numel() for l in leaves)
    assert n == cfg.param_count()


# -- the spec arithmetic (tests/test_substrates.py's cases) ----------------


def test_logical_spec_divisibility_drop():
    """kv=8 over a 16-wide model axis drops to replication; over a 1-wide
    one it keeps the axis."""
    for shape, want in (((16, 16), (None, None)), ((1, 1), ("model", None))):
        mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                     devices=np.empty(shape))
        for lib in (jrules, trules):
            spec = lib.logical_spec((8, 64), ("kv_heads", None),
                                    lib.DEFAULT_RULES, mesh)
            assert tuple(spec) == want


def test_logical_spec_shorter_prefix_retry():
    """("pod", "data") = 32 does not divide 16, its prefix ("pod",) = 2
    does."""
    mesh = stand_in("2x16x16")
    for lib in (jrules, trules):
        spec = lib.logical_spec((16, 64), ("batch", None),
                                lib.MULTIPOD_RULES, mesh)
        assert tuple(spec) == ("pod", None)
        spec = lib.logical_spec((64, 64), ("batch", None),
                                lib.MULTIPOD_RULES, mesh)
        assert tuple(spec) == (("pod", "data"), None)


def test_logical_spec_no_repeated_axes():
    mesh = stand_in("16x16")
    for lib in (jrules, trules):
        spec = lib.logical_spec((16, 16, 16), ("embed", "embed", "embed"),
                                lib.DEFAULT_RULES, mesh)
        flat = []
        for s in spec:
            if s is not None:
                flat.extend(s if isinstance(s, tuple) else (s,))
        assert len(flat) == len(set(flat)) == 1


@given(st.lists(st.integers(1, 512), min_size=1, max_size=4),
       st.sampled_from(sorted(MESHES)))
@settings(max_examples=60, deadline=None)
def test_logical_spec_equals_the_reference_on_random_shapes(dims, mesh_name):
    names = ["batch", "embed", "mlp", "heads"][: len(dims)]
    mesh = stand_in(mesh_name)
    rules = _mesh_rules(mesh_name)
    ref = tuple(jrules.logical_spec(dims, names, rules, mesh))
    got = trules.logical_spec(dims, names, rules, mesh)
    assert got == ref
    assert len(got) == len(dims)


def test_constrain_is_the_identity_outside_a_rule_context():
    x = torch.randn(2, 3, 4)
    assert trules.constrain(x, ("batch", "seq", "embed")) is x
    with trules.axis_rules(trules.DEFAULT_RULES):        # no mesh
        assert trules.constrain(x, ("batch", "seq", "embed")) is x
        assert trules.current_rules() is trules.DEFAULT_RULES
        assert trules.current_mesh() is None
    assert trules.current_rules() is None


# -- placements on a fake DeviceMesh ----------------------------------------


@pytest.fixture
def fake_mesh():
    """The 2×16×16 production mesh over the fake process group, destroyed
    after the test."""
    from repro_torch.launch.mesh import close_mesh, make_production_mesh
    mesh = make_production_mesh(multi_pod=True)
    try:
        yield mesh
    finally:
        close_mesh()


def test_placements_split_major_to_minor(fake_mesh):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard
    assert fake_mesh.mesh_dim_names == ("pod", "data", "model")
    spec = (("pod", "data"), None, "model")
    assert trules.to_placements(spec, fake_mesh) == (Shard(0), Shard(0),
                                                    Shard(2))
    assert trules.to_placements((None, None), fake_mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        trules.to_placements((("data", "pod"),), fake_mesh)
    mesh_, pl = trules.named_sharding(fake_mesh, (64, 8, 32),
                                      ("batch", None, "heads"),
                                      trules.MULTIPOD_RULES)
    assert mesh_ is fake_mesh and pl == (Shard(0), Shard(0), Shard(2))
    specs = {"tokens": torch.empty((64, 8), dtype=torch.int32, device="meta")}
    sh = tsh.batch_shardings(specs, fake_mesh, trules.MULTIPOD_RULES)
    assert sh["tokens"].spec == (("pod", "data"), None)
    with FakeTensorMode():
        placed = tsh.place(specs, sh, fake_mesh)["tokens"]
        assert tuple(placed.shape) == (64, 8)
        assert tuple(placed.to_local().shape) == (2, 8)
    assert tsh.local_bytes(specs, sh, fake_mesh) == 2 * 8 * 4


def test_production_mesh_refuses_a_smaller_group():
    """A group of fewer ranks than the mesh raises, as in the reference
    (the group is destroyed again before the test ends)."""
    from repro_torch.launch.mesh import close_mesh, make_production_mesh
    make_production_mesh()            # starts a 256-rank fake group
    try:
        with pytest.raises(RuntimeError, match="512"):
            make_production_mesh(multi_pod=True)
    finally:
        close_mesh()


# -- per-device argument bytes -----------------------------------------------


def _ref_local_bytes(tree, table, rules, mesh):
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    total = 0

    def f(path, leaf):
        nonlocal total
        spec = jsh._spec_for(path, leaf, table, rules, mesh)
        n = 1
        for d, axes in zip(leaf.shape, tuple(spec) + (None,) * leaf.ndim):
            if axes is not None:
                for a in (axes,) if isinstance(axes, str) else axes:
                    d //= sizes[a]
            n *= d
        total += n * jnp.dtype(leaf.dtype).itemsize
    jax.tree_util.tree_map_with_path(f, tree)
    return total


def _ref_argument_bytes(arch, shape_name, mesh_name):
    """The reference dry-run's arguments, reckoned from its specs: params
    (bf16), for train the fp32 moments, the int32 step and the batch; for
    prefill the batch and cache; for decode the cache, the token and the
    int32 pos."""
    ishape = INPUT_SHAPES[shape_name]
    cfg = JAX_REGISTRY[arch]
    model = jax_build_model(cfg, ishape)
    mesh = stand_in(mesh_name)
    rules = _ref_rules_for()(cfg, ishape, mesh)
    b, s = ishape.global_batch, ishape.seq_len
    ps = model.param_specs(jnp.bfloat16)
    total = _ref_local_bytes(ps, jsh.PARAM_LOGICAL, rules, mesh)
    if ishape.kind == "train":
        from repro.data.pipeline import make_batch_specs
        mom = jax.tree.map(
            lambda l: jax.ShapeDtypeStruct(l.shape, jnp.float32), ps)
        total += 2 * _ref_local_bytes(mom, jsh.PARAM_LOGICAL, rules, mesh)
        total += 4 + _ref_local_bytes(make_batch_specs(cfg, s, b),
                                      jsh.BATCH_LOGICAL, rules, mesh)
    elif ishape.kind == "prefill":
        total += _ref_local_bytes(model.input_specs(ishape),
                                  jsh.BATCH_LOGICAL, rules, mesh)
        total += _ref_local_bytes(model.cache_specs(b, s), jsh.CACHE_LOGICAL,
                                  rules, mesh)
    else:
        total += _ref_local_bytes(model.cache_specs(b, s), jsh.CACHE_LOGICAL,
                                  rules, mesh)
        total += 4 + _ref_local_bytes(
            {"token": jax.ShapeDtypeStruct((b, 1), jnp.int32)},
            jsh.BATCH_LOGICAL, rules, mesh)
    return total


COMBOS = [("phi3-mini-3.8b", "train_4k", "16x16"),
          ("granite-moe-3b-a800m", "train_4k", "16x16"),
          ("gemma2-9b", "decode_32k", "16x16"),
          ("phi3-mini-3.8b", "train_4k", "2x16x16"),
          ("qwen2-vl-72b", "prefill_32k", "16x16")]


@pytest.fixture(scope="module")
def port_argument_bytes():
    """The port's dry-run records for ``COMBOS`` with ``compile_=False``
    (arguments placed, nothing traced); each ``lower_one`` starts the
    fake process group and destroys it again."""
    from repro_torch.launch.dryrun import lower_one
    out = {}
    for arch, shape, mesh in COMBOS:
        rec = lower_one(arch, shape, multi_pod=mesh == "2x16x16",
                        compile_=False)
        out[f"{arch}/{shape}/{mesh}"] = rec["memory_analysis"]["argument_gb"]
    return out


@pytest.mark.parametrize("arch,shape,mesh", COMBOS)
def test_argument_bytes_equal_the_reference(port_argument_bytes, arch, shape,
                                            mesh):
    got = port_argument_bytes[f"{arch}/{shape}/{mesh}"]
    assert got * 1e9 == pytest.approx(_ref_argument_bytes(arch, shape, mesh),
                                      rel=1e-12, abs=0)
