"""repro_torch stands alone: importing any of its modules loads no JAX
and nothing of the reference ``repro`` package, and its default entry
points refuse to run on the host when CUDA is absent."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith(("jax.", "jaxlib"))
                or m == "repro" or m.startswith("repro."))
print(len(names))
print(",".join(leaked))
"""


def test_no_jax_and_no_reference_package_loaded():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.splitlines()
    assert int(out[0]) >= 30, "module walk found too few modules"
    assert out[1] == "", f"repro_torch loaded {out[1]}"


def test_default_entry_points_need_cuda():
    """get_engine() and the default backend run on the card; with no
    CUDA they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default engine is valid here")
    from repro_torch.engine import Engine, TorchBackend, get_engine
    with pytest.raises(RuntimeError, match="CUDA"):
        get_engine()
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine()
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchBackend()
    assert TorchBackend(device="cpu").device == "cpu"


def test_kernel_build_is_lazy():
    """Importing the kernel modules compiles nothing: the CUDA library
    is built at the first launch."""
    from repro_torch.kernels import _build
    assert _build.SOURCE.exists()
    assert _build.load_library.cache_info().currsize == 0 or \
        torch.cuda.is_available()
