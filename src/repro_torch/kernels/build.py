"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` (one
``nvcc`` per source, all started together), linked into one shared library
with a plain C interface, and loaded with ``ctypes``. The build happens at
first use, never at import, under ``build/kernels/`` at the repository
root (listed in ``.gitignore``). The library's file name carries a hash of
the sources, the headers they share and the flags, so an edited source or
header never loads a stale build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("flash_attention.cu", "paged_attention.cu", "decode_attention.cu",
           "ssd_scan.cu")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              *ARCH_FLAGS)

#: the element types the kernels take, by the code their C entry points read
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: shared memory a block may use on Hopper (bytes)
MAX_SMEM_BYTES = 232448

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "flash_attention_fwd": (
        [_P, _P, _P, _P, _I] + [_I] * 6 + [_LL] * 12 + [_F, _I, _I, _F, _P, _P],
        _I),
    "paged_decode_attention_fwd": (
        [_P, _P, _P, _P, _I, _I, _P, _P, _I, _P, _I] + [_I] * 5
        + [_F, _F, _I, _P, _P, _P], _I),
    "paged_decode_attention_smem_bytes": ([_I] * 5, ctypes.c_size_t),
    "decode_attention_fwd": (
        [_P, _P, _P, _P, _I, _LL, _P] + [_I] * 5 + [_LL] * 4
        + [_F, _F, _I, _P, _P, _P], _I),
    "decode_attention_smem_bytes": ([_I] * 5, ctypes.c_size_t),
    "ssd_scan_fwd": ([_P] * 6 + [_I] * 7 + [_LL] * 12 + [_P], _I),
    "ssd_scan_smem_bytes": ([_I] * 6, ctypes.c_size_t),
    "hyperoffload_cuda_error_string": ([_I], ctypes.c_char_p),
}

_lock = threading.Lock()
#: the library this process loaded (later launches take it from here,
#: without hashing the sources again)
_library: Optional[ctypes.CDLL] = None
#: what the last build in this process did: seconds, command lines, and the
#: compiler's register/shared-memory report (``-Xptxas -v``)
last_build: Dict[str, object] = {}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the PATH, else the CUDA
    toolkit's default install location."""
    candidates: List[Optional[str]] = []
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            candidates.append(os.path.join(os.environ[env], "bin", "nvcc"))
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on the PATH); the port's "
        "CUDA kernels are built from source at first use")


def library_path() -> Path:
    """The library's path, named by a hash of every source and header under
    ``csrc/`` (sorted) and of the flags."""
    h = hashlib.sha256()
    for path in sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libhyperoffload_kernels_{h.hexdigest()[:16]}.so"


def compile_commands(nvcc: str, out_dir: Path, lib: Path) -> List[List[str]]:
    """One compile command per source, then the link command (last)."""
    cmds = [[nvcc, *NVCC_FLAGS, "-c", str(CSRC / name),
             "-o", str(out_dir / (Path(name).stem + ".o"))] for name in SOURCES]
    objs = [str(out_dir / (Path(name).stem + ".o")) for name in SOURCES]
    cmds.append([nvcc, "-shared", *ARCH_FLAGS, *objs, "-ldl", "-o", str(lib)])
    return cmds


def build(lib: Path) -> None:
    """Compile every source in parallel, link, and move the library into
    place atomically (a concurrent loader never sees a half-written file)."""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_dir = Path(tmp)
        tmp_lib = tmp_dir / lib.name
        *compiles, link = compile_commands(nvcc, tmp_dir, tmp_lib)
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in compiles]
        logs = [p.communicate()[0] for p in procs]
        for cmd, proc, log in zip(compiles, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
        res = subprocess.run(link, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"link failed: {' '.join(link)}\n{res.stdout}")
        os.replace(tmp_lib, lib)
    last_build.update(seconds=time.perf_counter() - t0,
                      commands=[" ".join(c) for c in compiles + [link]],
                      log="".join(logs) + res.stdout)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    global _library
    if _library is None:
        with _lock:
            if _library is None:
                lib_path = library_path()
                if not lib_path.exists():
                    build(lib_path)
                lib = ctypes.CDLL(str(lib_path))
                for name, (argtypes, restype) in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = restype
                _library = lib
    return _library


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (``cudaGetLastError``)."""
    if err != 0:
        msg = load_library().hyperoffload_cuda_error_string(err)
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({msg.decode() if msg else 'unknown'})")
