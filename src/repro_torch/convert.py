"""Load parameters and optimizer state made by the JAX package into the
port.

The port keeps the reference's stacked per-segment layout, so conversion is
a copy leaf by leaf: ``params_from_numpy(jax.tree.map(np.asarray, params),
device)`` gives parameters the port's model runs as they are, and
``opt_state_from_numpy`` an ``AdamWState`` the port's train step continues
from. This module imports neither JAX nor the JAX package; the caller turns
JAX arrays into numpy arrays first.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def tensor_from_numpy(a: np.ndarray, device: torch.device,
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Copy one array onto ``device``. JAX hands out read-only buffers, so
    the array is always copied rather than shared. ``ml_dtypes.bfloat16``
    arrays, which torch cannot read directly, are carried over by their
    bits. ``dtype`` casts floating-point leaves."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a.view(np.int16))).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree: Any, device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None) -> Any:
    """Nested dicts/lists/tuples of numpy arrays → the same nesting of
    tensors on ``device`` (default CUDA). ``dtype`` casts every floating
    leaf, including those the reference keeps in fp32 whatever the model's
    type (norm scales; Mamba2's ``A_log``, ``D``, ``dt_bias`` and
    ``gate_norm``): leave it ``None`` to keep the reference's types."""
    dev = resolve_device(device)

    def conv(node: Any) -> Any:
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        return tensor_from_numpy(node, dev, dtype)

    return conv(tree)


def opt_state_from_numpy(step: Any, mu: Any, nu: Any,
                         device: DeviceLike = None):
    """A JAX ``AdamWState``'s fields as numpy (the step counter and the two
    fp32 moment trees) → the port's ``AdamWState``: the step on the CPU,
    the moments on ``device`` (move them to the host with
    ``offload.optstate.host_offload_state`` for optimizer-state offload)."""
    from repro_torch.optim.adamw import AdamWState
    return AdamWState(step=torch.tensor(int(np.asarray(step)),
                                        dtype=torch.int32),
                      mu=params_from_numpy(mu, device),
                      nu=params_from_numpy(nu, device))
