"""Device meshes (the counterpart of ``repro.launch.mesh``).

Functions, never module-level constants: importing this module starts no
process group. :func:`make_debug_mesh` builds a small mesh on the ranks
that exist (one card, or the CPU in tests); :func:`make_production_mesh`
builds the 16×16 (or 2×16×16) production mesh over the *fake* process
group, which runs no communication: every rank is this process, and a
``DTensor`` on the mesh holds rank 0's shard. That is what the dry-run
needs: the shapes, placements and collectives of one device's program,
with ``FakeTensorMode`` tensors that allocate nothing.
"""

from __future__ import annotations

import os
import tempfile
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import DeviceLike, resolve_device


def _mesh(device_type: str, shape: Tuple[int, ...],
          axes: Sequence[str]) -> DeviceMesh:
    n = int(np.prod(shape))
    if dist.get_world_size() == n:
        return init_device_mesh(device_type, tuple(shape),
                                mesh_dim_names=tuple(axes))
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))


def make_debug_mesh(shape=(1, 1), axes=("data", "model"),
                    device: DeviceLike = None) -> DeviceMesh:
    """A small mesh on ``device`` (default CUDA). It uses the process group
    that is up, or else starts a single-rank one: NCCL on a ``FileStore``
    in a temporary directory for the card, gloo for the CPU. A mesh of
    more than one rank needs a group of that many ranks already up."""
    dev = resolve_device(device)
    n = int(np.prod(shape))
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(f"a {tuple(shape)} mesh needs a process group "
                               f"of {n} ranks; start one first")
        backend = "nccl" if dev.type == "cuda" else "gloo"
        store = dist.FileStore(os.path.join(tempfile.mkdtemp(), "store"), 1)
        dist.init_process_group(backend, store=store, rank=0, world_size=1)
    if dist.get_world_size() < n:
        raise RuntimeError(f"need {n} ranks for mesh {tuple(shape)}, "
                           f"have {dist.get_world_size()}")
    return _mesh(dev.type, tuple(shape), axes)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16×16 = 256 devices ("data", "model"); the multi-pod variant is
    2×16×16 = 512 ("pod", "data", "model"), over the fake process group
    on the CPU. Starts that group when none is up; raises, as the
    reference does, when a group with fewer ranks is already up."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    if not dist.is_initialized():
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    if dist.get_world_size() < n:
        raise RuntimeError(
            f"need {n} ranks for mesh {shape}, have {dist.get_world_size()}: "
            "destroy the process group first, or let make_production_mesh "
            "start the fake one (launch/dryrun.py does this)")
    return _mesh("cpu", shape, axes)


def close_mesh() -> None:
    """Destroy the default process group, if one is up (the debug and
    production meshes' group)."""
    if dist.is_initialized():
        dist.destroy_process_group()
