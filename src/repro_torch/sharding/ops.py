"""The model's products, reshapes and per-head cores in forms a device
mesh can run.

On plain tensors every function here is the plain operation (``x @ w``,
``reshape``, ``fn(*args)``), so no run outside a mesh changes by a bit.
On ``DTensor``s they name, at each point where ``DTensor``'s own sharding
propagation has no strategy (or a wrong one), how the work is split:

- :func:`linear` (activation × weight): a 3-D activation folded into one
  ``mm`` merges two sharded dims (batch over ``data``, sequence over
  ``model``) into one ``DTensor`` cannot shard, so the product runs on
  each device's local blocks (``local_map``): batch and sequence shards
  stay, a weight's fsdp rows are gathered, a column-parallel weight gives
  column shards, a contraction sharded on both sides gives partial sums;
- :func:`split_heads`: unflattening ``H·D`` into ``(H, D)`` where the
  ``H·D`` dim is split over more devices than there are heads (GQA kv=8 on
  a 16-way axis) first replicates that dim;
- :func:`local_over`: attention's and the SSM's cores (scores, masks,
  softmax, products) run per device on the dims that are independent in
  them (batch and heads): mesh dims that split anything else are
  replicated first, as XLA's partitioner gathers K/V;
- :func:`embed_lookup`: a table lookup (``aten.index``, and its
  ``index_put`` backward) has no ``DTensor`` strategy for a batch split
  over two mesh dims: each device looks up its own tokens in its vocab
  rows (zero elsewhere), summed over the vocab's split (Megatron's
  vocab-parallel embedding);
- :func:`write_local`: a ring write into a cache (``index_copy_``,
  ``roll``, an indexed assignment) runs on each device's shard of the
  cache, the written values split as the cache is; :func:`replicated`
  first gathers a split of the dim the write indexes (a ring split over
  its slots), which is then copied back shard by shard.

On a one-device mesh every local tensor is the whole tensor, so each of
these runs the plain operation on the same tensors.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch


_DTensor = None      # torch.distributed.tensor's class, imported once


def is_dtensor(t) -> bool:
    """Whether ``t`` is a ``DTensor``; the class is imported on the first
    call (importing ``torch.distributed.tensor`` takes about a second)."""
    global _DTensor
    if _DTensor is None:
        from torch.distributed.tensor import DTensor
        _DTensor = DTensor
    return isinstance(t, _DTensor)


def _mesh_of(*ts):
    return next(t.device_mesh for t in ts if is_dtensor(t))


def _as_dt(t, mesh):
    from torch.distributed.tensor import DTensor, Replicate
    if is_dtensor(t):
        return t
    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (..., K) @ w (K, N)``, in the promoted type of the two where
    they differ (fp32 activations over bf16 weights run in fp32, as
    ``jnp``'s ``@`` promotes). Under a mesh, per mesh dim: a split of a
    leading dim of ``x`` stays (``w`` gathered there: fsdp); else a split
    of ``K`` on ``x`` meets ``w`` split by rows (partial sums); else a
    column split of ``w`` stays (column shards of the output); anything
    else is gathered."""
    if x.dtype != w.dtype:
        t = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(t), w.to(t)
    if not (is_dtensor(x) or is_dtensor(w)):
        return x @ w
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = _mesh_of(x, w)
    x, w = _as_dt(x, mesh), _as_dt(w, mesh)
    last = x.ndim - 1
    xp, wp, op, xg, wg = [], [], [], [], []
    for px, pw in zip(x.placements, w.placements):
        if px.is_partial():
            px = Replicate()
        if px.is_shard() and px.dim < last:       # batch / sequence split
            a, b, o = px, Replicate(), px
            ga, gb = px, Partial()
        elif px.is_shard():                       # contraction split
            a, b, o = px, Shard(0), Partial()
            ga, gb = px, Shard(0)
        elif pw.is_shard() and pw.dim == 1:       # column parallel
            a, b, o = Replicate(), pw, Shard(last)
            ga, gb = Partial(), pw
        else:                                     # fsdp rows gathered
            a, b, o = Replicate(), Replicate(), Replicate()
            ga, gb = Replicate(), Replicate()
        xp.append(a), wp.append(b), op.append(o), xg.append(ga)
        wg.append(gb)
    return local_map(torch.matmul, out_placements=list(op),
                     in_placements=(tuple(xp), tuple(wp)),
                     in_grad_placements=(tuple(xg), tuple(wg)),
                     device_mesh=mesh, redistribute_inputs=True)(x, w)


def split_heads(t: torch.Tensor, heads: int, head_dim: int) -> torch.Tensor:
    """``t (..., heads·head_dim)`` as ``(..., heads, head_dim)``; a mesh
    split of the last dim that the head count does not divide is gathered
    first."""
    shape = tuple(t.shape[:-1]) + (heads, head_dim)
    if not is_dtensor(t):
        return t.reshape(shape)
    from torch.distributed.tensor import Replicate
    last = t.ndim - 1
    sizes = t.device_mesh.shape
    n = math.prod(sizes[i] for i, p in enumerate(t.placements)
                  if p.is_shard() and p.dim == last)
    if heads % n:
        t = t.redistribute(t.device_mesh, tuple(
            Replicate() if p.is_shard() and p.dim == last else p
            for p in t.placements))
    return t.reshape(shape)


Roles = Optional[Dict[str, int]]


def local_over(fn: Callable, args: Sequence, roles: Sequence[Roles],
               out_roles) -> object:
    """``fn(*args)`` run on each device's local blocks. ``roles[i]`` names
    the dims of tensor ``args[i]`` along which ``fn`` is independent (e.g.
    ``{"b": 0, "h": 2}``), or is ``None`` for an argument passed whole (a
    plain tensor is then taken as replicated). A mesh dim keeps its split
    where every argument with roles splits the dim of one role, and no
    argument without that role is split there; any other mesh dim is
    gathered. ``out_roles`` gives the roles of ``fn``'s output (a dict) or
    outputs (a tuple of dicts)."""
    dts = [a for a in args if is_dtensor(a)]
    if not dts:
        return fn(*args)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = dts[0].device_mesh
    args = [(_as_dt(a, mesh) if isinstance(a, torch.Tensor) else a)
            for a in args]
    role_args = [(a, r) for a, r in zip(args, roles) if r is not None]
    keep = []                       # per mesh dim: the role kept, or None
    for m in range(mesh.ndim):
        role = None
        ok = True
        for a, r in role_args:
            p = a.placements[m]
            if p.is_partial():
                ok = False
                break
            if not p.is_shard():
                continue
            got = next((k for k, d in r.items() if d == p.dim), None)
            if got is None or (role is not None and got != role):
                ok = False
                break
            role = got
        if ok and role is not None:
            ok = all(r.get(role) is not None
                     and a.placements[m] == Shard(r[role])
                     for a, r in role_args)
        keep.append(role if ok else None)

    def placements(r: Dict[str, int]):
        return tuple(Shard(r[k]) if k is not None and k in r else Replicate()
                     for k in keep)

    in_pl = []
    for a, r in zip(args, roles):
        if not isinstance(a, torch.Tensor):
            in_pl.append(None)
        else:
            in_pl.append(placements(r) if r is not None
                         else (Replicate(),) * mesh.ndim)
    # local_map reads a tuple as one entry per output
    out_pl = tuple(placements(r) for r in out_roles) \
        if isinstance(out_roles, tuple) else list(placements(out_roles))
    return local_map(fn, out_placements=out_pl, in_placements=tuple(in_pl),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def replicated(t: torch.Tensor, dim: int) -> Tuple[torch.Tensor, bool]:
    """``t`` with mesh splits of ``dim`` gathered, and whether any was:
    the tensor an in-place write along ``dim`` can take."""
    if not is_dtensor(t) or not any(p.is_shard() and p.dim == dim
                                for p in t.placements):
        return t, False
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, tuple(
        Replicate() if p.is_shard() and p.dim == dim else p
        for p in t.placements)), True


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``: rows of a (V, D) table at integer ``tokens``.
    Under a mesh, per mesh dim: a split of ``tokens`` stays (the table
    gathered there); else a vocab split of the table stays, each device
    giving the rows it holds and zero for the rest, a partial sum; the
    table's ``D`` split is gathered."""
    if not (is_dtensor(table) or is_dtensor(tokens)):
        return table[tokens]
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = _mesh_of(table, tokens)
    table, tokens = _as_dt(table, mesh), _as_dt(tokens, mesh)
    tab_pl, tok_pl, out_pl, tab_grad, vocab_dims = [], [], [], [], []
    for m, (pt, pk) in enumerate(zip(table.placements, tokens.placements)):
        if pk.is_shard():
            tab_pl.append(Replicate()), tok_pl.append(pk)
            out_pl.append(pk), tab_grad.append(Partial())
        elif pt.is_shard() and pt.dim == 0:
            tab_pl.append(pt), tok_pl.append(Replicate())
            out_pl.append(Partial()), tab_grad.append(pt)
            vocab_dims.append(m)
        else:
            tab_pl.append(Replicate()), tok_pl.append(Replicate())
            out_pl.append(Replicate()), tab_grad.append(Replicate())
    sizes = tuple(mesh.shape)

    def local(tab, tok):
        if math.prod(sizes[m] for m in vocab_dims) == 1:
            return tab[tok]
        coord = mesh.get_coordinate()
        idx = 0
        for m in vocab_dims:
            idx = idx * sizes[m] + coord[m]
        rel = tok - idx * tab.shape[0]
        hit = (rel >= 0) & (rel < tab.shape[0])
        rows = tab[rel.clamp(0, tab.shape[0] - 1)]
        return torch.where(hit[..., None], rows, rows.new_zeros(()))

    return local_map(local, out_placements=out_pl,
                     in_placements=(tuple(tab_pl), tuple(tok_pl)),
                     in_grad_placements=(tuple(tab_grad), tuple(tok_pl)),
                     device_mesh=mesh, redistribute_inputs=True)(table, tokens)


def write_local(fn: Callable, buf: torch.Tensor, *args):
    """``fn(buf, *args)``, which writes ``buf`` in place. Under a mesh,
    ``fn`` writes each device's shard of ``buf`` where it lies: a tensor
    argument of ``buf``'s rank (the values, dim for dim beside ``buf``'s
    but the one ``fn`` indexes, which ``buf`` must not split) is split as
    ``buf`` is; a 1-D one (a per-row position) as ``buf``'s dim 0; a 0-dim
    one is replicated."""
    if not is_dtensor(buf):
        return fn(buf, *args)
    from torch.distributed.tensor import Replicate, Shard
    mesh = buf.device_mesh
    local = []
    for a in args:
        if isinstance(a, torch.Tensor):
            a = _as_dt(a, mesh)
            if a.ndim == buf.ndim:
                pl = tuple(buf.placements)
            else:
                pl = tuple(p if p == Shard(0) and a.ndim == 1 else Replicate()
                           for p in buf.placements)
            a = a.redistribute(mesh, pl).to_local()
        local.append(a)
    return fn(buf.to_local(), *local)
