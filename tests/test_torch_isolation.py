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


# Functions whose imports run only when they are called: the trace's
# PROG table and loader, the disk cache's (de)serialization, the cost
# model over a planned block from the port's configs, a replay, and a
# smoke model's forward with every projection on the PIM path.
_LAZY_PROBE = r"""
import dataclasses, os, sys, tempfile
os.environ["REPRO_CACHE_DIR"] = tempfile.mkdtemp()
from repro_torch.compiler import ProgramCache
from repro_torch.compiler.serialize import entry_from_bytes, entry_to_bytes
from repro_torch.configs import get_config
from repro_torch.device import (CommandTrace, DeviceConfig, TraceRecorder,
                                block_trace, charge)
from repro_torch.engine import Engine
from repro_torch.pim import plan_block
eng = Engine("torch:device=cpu")
ent = ProgramCache().get_or_compile("multpim", 4)
entry_from_bytes(entry_to_bytes(ent), key=ent.key)
assert ProgramCache().get_or_compile("multpim", 4).from_disk
dev = DeviceConfig.parse("1x1x1x1", crossbar=eng.crossbar)
rec = TraceRecorder(dev)
eng.compile_group([("multpim", 4)]).run([{"a": [3], "b": [5]}],
                                        recorder=rec)
back = CommandTrace.loads(rec.trace.dumps())
assert back.progs() and back.verify_replay(eng) == 1
cfg = dataclasses.replace(get_config("gemma2-9b", smoke=True),
                          pim_linear_mode="pim")
charge(block_trace(plan_block(cfg, eng, scopes=("head",)), dev))
import torch
from repro_torch.models import build_model
model = build_model(dataclasses.replace(cfg, pim_block_mode="full"),
                    engine=eng)
logits, _ = model.forward(model.init(0), torch.tensor([[3, 4, 5]]))
assert logits.shape == (1, 3, cfg.vocab_size)
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith(("jax.", "jaxlib"))
                or m == "repro" or m.startswith("repro."))
print(",".join(leaked))
"""


def test_lazy_imports_load_no_reference_package():
    """Calling the functions that import inside their bodies (trace
    loading and replay, disk entries, block traces, a model forward
    under ``pim_block_mode="full"``) loads no JAX and nothing of
    ``repro`` either."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    out = subprocess.run([sys.executable, "-c", _LAZY_PROBE], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.splitlines()
    assert out == [""], f"repro_torch loaded {out}"


def test_default_entry_points_need_cuda():
    """get_engine(), the default backend and the dry-run's default
    device run on the card; with no CUDA they raise instead of running
    on the CPU."""
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
    from repro_torch.launch import dryrun
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.main(["--arch", "rwkv6-7b", "--shape", "long_500k"])


def test_kernel_build_is_lazy():
    """Importing the kernel modules compiles nothing: the CUDA library
    is built at the first launch."""
    from repro_torch.kernels import _build
    names = {src.name for src in _build.SOURCES}
    assert {"crossbar_step.cu", "bitserial_matmul.cu"} <= names
    assert _build.load_library.cache_info().currsize == 0 or \
        torch.cuda.is_available()


# The sharded-training modules of the port, imported alone: the process
# group layer and every module it changed.
_DIST_PROBE = r"""
import sys
import repro_torch.dist, repro_torch.launch.mesh, repro_torch.launch.train
import repro_torch.launch.elastic, repro_torch.train.step
import repro_torch.train.sharding, repro_torch.train.checkpoint
import repro_torch.train.fault, repro_torch.optim.adamw
import repro_torch.optim.compress, repro_torch.models.blocks
import repro_torch.models.transformer, repro_torch.models.model
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith(("jax.", "jaxlib"))
                or m == "repro" or m.startswith("repro."))
print(",".join(leaked))
"""


def test_dist_and_sharded_modules_load_no_reference_package():
    """``repro_torch.dist`` and the modules sharded training changed load
    no JAX and nothing of ``repro``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    out = subprocess.run([sys.executable, "-c", _DIST_PROBE], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.splitlines()
    assert out == [""], f"repro_torch loaded {out}"


def test_dist_without_a_process_group():
    """One process: every collective over a ``None`` group (an axis of
    one rank) is the identity, a mesh without process groups gives
    size-1 axes, and ``init_distributed`` refuses a
    backend it does not know, nccl without CUDA, and a missing
    ``torch.distributed.run`` environment, rather than choosing
    another."""
    from repro_torch import dist
    from repro_torch.launch.mesh import make_host_mesh
    x = torch.arange(6.0).reshape(2, 3).requires_grad_()
    assert dist.all_reduce(x.detach(), None) is not None
    for f in (lambda t: dist.all_gather(t, None, 1),
              lambda t: dist.reduce_scatter(t, None, 1),
              lambda t: dist.copy_to_parallel(t, None),
              lambda t: dist.reduce_from_parallel(t, None),
              lambda t: dist.gather_from_parallel(t, None, 0)):
        assert torch.equal(f(x), x)
    assert dist.broadcast_int(7, None) == 7
    assert dist.all_gather_ints(3, None) == [3]
    dist.barrier(None)
    assert not dist.is_initialized() and dist.world_size() == 1
    mesh = make_host_mesh()
    assert mesh.comm is None and mesh.size == 1
    assert dist.mesh_axis(mesh, ("data",)).size == 1
    with pytest.raises(ValueError, match="backend"):
        dist.init_distributed("mpi")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            dist.init_distributed("nccl")
    env = {k: os.environ.pop(k) for k in ("RANK", "WORLD_SIZE",
                                          "MASTER_ADDR", "MASTER_PORT")
           if k in os.environ}
    try:
        with pytest.raises(RuntimeError, match="torch.distributed.run"):
            dist.init_distributed("gloo")
    finally:
        os.environ.update(env)
    assert not dist.is_initialized()
