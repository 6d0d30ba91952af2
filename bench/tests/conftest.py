"""The benchmark's own CPU tests: ``python -m pytest -q bench/tests`` from
the root of the repository. They put the benchmark's modules and the
port's sources on the path, as ``bench/run.py`` does."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "bench"), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)
