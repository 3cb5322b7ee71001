"""The PyTorch port stands alone: it imports with JAX absent, and neither
the package, ``chip_smoke.py`` nor the card's tests (``test_torch_cuda.py``,
run where JAX is not installed) import JAX or the JAX package."""

import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any ``import jax`` now raises
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
for name in ("repro_torch.models.ssm", "repro_torch.kernels.ssd_scan",
             "repro_torch.configs.mamba2_370m", "repro_torch.configs.zamba2_7b",
             *(f"repro_torch.core.{m}" for m in (
                 "ir", "costmodel", "lifetime", "memsim", "timeline",
                 "schedule", "allocator", "insertion", "planner", "tracer")),
             "repro_torch.slo.policy", "repro_torch.obs.metrics",
             *(f"repro_torch.sched.{m}" for m in (
                 "requests", "queue", "prefetch", "scheduler"))):
    assert name in names, name
assert "repro" not in sys.modules, "the JAX package was imported"
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules
               if sys.modules[m] is not None)
print(len(names))
"""


def test_every_port_module_imports_without_jax():
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL],
                         cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                                        "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip().splitlines()[-1]) >= 45


_JAX_PACKAGE_IMPORT = re.compile(
    r"^\s*(import\s+(repro|jax)\b(?!_)|from\s+(repro|jax)(\.|\s+import\b))",
    re.MULTILINE)


def test_no_port_file_imports_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                          ROOT / "tests" / "test_torch_cuda.py"]
    assert len(files) > 45
    offenders = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
                 for f in files
                 for m in _JAX_PACKAGE_IMPORT.finditer(f.read_text())]
    assert not offenders, offenders
