"""The benchmark's own CPU tests: ``python -m pytest -q perfbench/tests``
from the repository root (the repository's tier-1 run does not collect
them)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
