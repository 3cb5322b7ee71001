"""Mamba2 SSD chunked scan: the wrapper of the Hopper kernel in
``csrc/ssd_scan.cu``, which replaces the JAX package's Pallas kernel
``repro.kernels.ssd_scan.ssd_scan_pallas``.

:func:`ssd_scan_cuda` takes CUDA tensors in the model's layout, read in
place through their strides (B and C may broadcast one group to every head
with head stride 0). The model calls it through ``ops.ssd_scan``, which
runs the plain version (``ref.ssd_scan_ref``) for tensors on the CPU. There
is no backward kernel (the JAX package has none either), so inputs that
require grad are refused.

The type of B and C fixes the kernel instance, never a fallback:
``"mma_tf32"`` for bf16 (the model's serving paths: every product on
tensor cores, kept at fp32 accuracy by a hi/lo TF32 split) and
``"fma_f32"`` for fp32 (CUDA-core FMA). ``ssd_scan_cuda.instances`` counts
the launches of each.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import DTYPE_CODES, MAX_SMEM_BYTES

MAX_STATE_DIM = 128


def ssd_scan_cuda(x: torch.Tensor, a: torch.Tensor, b_mat: torch.Tensor,
                  c_mat: torch.Tensor, chunk: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,H,P) fp32 pre-scaled by dt, a (B,S,H) fp32 = dt*A, B/C
    (B,S,H,N) in fp32 or bf16 → (y (B,S,H,P) fp32, final state (B,H,P,N)
    fp32). ``S`` must be a multiple of ``chunk``."""
    tensors = (("x", x), ("a", a), ("b_mat", b_mat), ("c_mat", c_mat))
    for name, t in tensors:
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} must be a CUDA tensor on {x.device}, "
                             f"got {t.device}")
        if t.requires_grad:
            raise ValueError(f"{name} requires grad; the SSD kernel has no "
                             "backward")
    if x.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"x and a must be float32, got {x.dtype}, {a.dtype}")
    if b_mat.dtype not in DTYPE_CODES or c_mat.dtype != b_mat.dtype:
        raise TypeError(f"b_mat/c_mat: dtypes {b_mat.dtype}, {c_mat.dtype}; "
                        "the kernel takes float32 or bfloat16, the same for "
                        "both")
    if x.dim() != 4:
        raise ValueError(f"x must be (B,S,H,P), got {tuple(x.shape)}")
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    if tuple(a.shape) != (bsz, s, h):
        raise ValueError(f"a {tuple(a.shape)} does not match x "
                         f"{tuple(x.shape)}")
    if b_mat.shape != c_mat.shape or tuple(b_mat.shape[:3]) != (bsz, s, h) \
            or b_mat.dim() != 4:
        raise ValueError(f"b_mat {tuple(b_mat.shape)} / c_mat "
                         f"{tuple(c_mat.shape)} do not match x "
                         f"{tuple(x.shape)}")
    for name, t in (("x", x), ("b_mat", b_mat), ("c_mat", c_mat)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the last dim must be contiguous "
                             f"(strides {t.stride()})")
    if chunk < 1 or s % chunk:
        raise ValueError(f"S={s} is not a multiple of chunk={chunk}")
    if not 0 < n <= MAX_STATE_DIM:
        raise ValueError(f"state dim N={n} outside (0, {MAX_STATE_DIM}]")
    lib = build.load_library()
    bc_code = DTYPE_CODES[b_mat.dtype]
    smem = lib.ssd_scan_smem_bytes(bc_code, bsz, h, p, n, chunk)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"chunk={chunk}, N={n} need {smem} B of shared "
                         f"memory, more than {MAX_SMEM_BYTES}")
    y = torch.empty((bsz, s, h, p), dtype=torch.float32, device=x.device)
    state = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    if y.numel() == 0 or state.numel() == 0:
        return y, state.zero_()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_scan_fwd(
            x.data_ptr(), a.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
            y.data_ptr(), state.data_ptr(), bc_code,
            bsz, s, h, p, n, chunk, *x.stride()[:3], *a.stride(),
            *b_mat.stride()[:3], *c_mat.stride()[:3], stream)
    build.check(err, "ssd_scan_fwd")
    ssd_scan_cuda.launches += 1
    ssd_scan_cuda.instances[INSTANCES[b_mat.dtype]] += 1
    return y, state


#: the kernel instance each type of B/C takes
INSTANCES = {torch.bfloat16: "mma_tf32", torch.float32: "fma_f32"}
#: launches of the kernel in this process (set to 0 to start a count)
ssd_scan_cuda.launches = 0
#: launches by instance (``ops.reset_launch_counts`` sets them to 0)
ssd_scan_cuda.instances = dict.fromkeys(INSTANCES.values(), 0)
