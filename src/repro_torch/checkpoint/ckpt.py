"""Numpy ``.npz`` checkpoints of parameter and optimizer trees (the
counterpart of ``repro.checkpoint.ckpt``).

The file is the reference's, key for key: a tree's leaves flattened under
keys joined by ``/`` from dict keys (sorted), list and tuple indices and
``.field`` for a named tuple's fields (as JAX's key paths print them);
bf16 and fp8 leaves stored as fp32; written to a temporary file and
renamed into place; beside it a JSON manifest with the step, the tree's
structure in JAX's ``PyTreeDef`` notation and the sorted keys. So either
package loads what the other wrote.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _items(tree: Any, path: Tuple[str, ...] = ()
           ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], path + (str(k),))
    elif _is_namedtuple(tree):
        for name, v in zip(tree._fields, tree):
            yield from _items(v, path + (f".{name}",))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, path + (str(i),))
    elif tree is not None:
        yield path, tree


def _treedef(tree: Any) -> str:
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    if _is_namedtuple(tree):
        return (f"CustomNode(namedtuple[{type(tree).__name__}], ["
                + ", ".join(_treedef(v) for v in tree) + "])")
    if isinstance(tree, list):
        return "[" + ", ".join(_treedef(v) for v in tree) + "]"
    if isinstance(tree, tuple):
        inner = ", ".join(_treedef(v) for v in tree)
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    return "*"


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype in (torch.bfloat16, torch.float8_e4m3fn,
                       torch.float8_e5m2):
            t = t.float()   # no numpy dtype: fp32 on disk, as the reference
        return t.numpy()
    return np.asarray(leaf)


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    return {"/".join(path): _to_numpy(leaf) for path, leaf in _items(tree)}


def save_checkpoint(path: str, tree: Any, step: int = 0) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten(tree)
    tmp = tempfile.NamedTemporaryFile(
        dir=os.path.dirname(path) or ".", suffix=".tmp", delete=False)
    try:
        np.savez(tmp, **flat)
        tmp.close()
        os.replace(tmp.name, path)
    finally:
        if os.path.exists(tmp.name):
            os.unlink(tmp.name)
    with open(path + ".json", "w") as f:
        json.dump({"step": step, "treedef": f"PyTreeDef({_treedef(tree)})",
                   "keys": sorted(flat)}, f)


def load_checkpoint(path: str, like: Any) -> Tuple[Any, int]:
    """Restore into the structure of ``like``: every leaf takes its
    ``like`` leaf's dtype and device; a missing key raises ``KeyError``, a
    shape that differs ``ValueError``."""
    with open(path + ".json") as f:
        meta = json.load(f)
    with np.load(path) as data:
        loaded = {}
        for keys, leaf in _items(like):
            key = "/".join(keys)
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: shape {arr.shape} != "
                                 f"{tuple(leaf.shape)}")
            loaded[keys] = torch.from_numpy(np.array(arr)).to(
                device=leaf.device, dtype=leaf.dtype)
    return _rebuild(like, loaded, ()), meta["step"]


def _rebuild(like: Any, loaded: Dict, path: Tuple[str, ...]) -> Any:
    if isinstance(like, dict):
        return {k: _rebuild(v, loaded, path + (str(k),))
                for k, v in like.items()}
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(v, loaded, path + (f".{n}",))
                            for n, v in zip(like._fields, like)))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, loaded, path + (str(i),))
                          for i, v in enumerate(like))
    return None if like is None else loaded[path]
