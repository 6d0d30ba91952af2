"""The port of ``tests/test_elastic_multidevice.py``: elastic restart
across mesh shapes with one process a rank.

Eight gloo ranks train deepseek-7b smoke on a (4, 2) (data, model) mesh
for 4 steps and checkpoint; the first four ranks survive, re-mesh to
(2, 2) with ``elastic_remesh`` (their own process groups), restore the
mesh-agnostic checkpoint sharded for the new mesh and train 3 more
steps (``repro_torch.launch.elastic``). The reference test's own script,
a copy below, runs the same schedule on 8 simulated JAX devices in a
subprocess meanwhile; both start from the reference's
``init_fn(PRNGKey(0))`` (the port's through a checkpoint the reference
wrote).

Tolerances: the port's ``l1``, ``l2`` and ``r2`` against the reference's
within 1e-4 absolute (50 times under the reference test's own 5e-3
between its ``l2`` and ``r2``: the packages order float32 sums
differently, and AdamW carries that through 7 steps); the port's ``l2``
against its own uninterrupted ``r2`` within 1e-5 relative (the same
package on two meshes: only the order of the sums over ranks changes).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

torch = pytest.importorskip("torch")

import _torch_sharded_cases as cases  # noqa: E402
from _torch_dist import run_ranks  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.optim import adamw as ja  # noqa: E402
from repro.train import save_checkpoint as jax_save  # noqa: E402

pytestmark = pytest.mark.infra

ROOT = Path(__file__).resolve().parents[1]
REF_TOL = 1e-4
SELF_RTOL = 1e-5

# tests/test_elastic_multidevice.py's script, as it is there.
_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
import jax, jax.numpy as jnp
from jax.sharding import Mesh
import numpy as np

sys.path.insert(0, "src")
from repro.configs import get_config
from repro.data import DataConfig, make_batch_fn
from repro.models import build_model
from repro.optim import AdamWConfig
from repro.train import make_train_step, save_checkpoint, restore_checkpoint
from repro.train.fault import elastic_remesh
from repro.train.sharding import param_shardings

ckpt = sys.argv[1]
cfg = get_config("deepseek-7b", smoke=True)
model = build_model(cfg)
opt = AdamWConfig(lr=2e-3, warmup_steps=1, total_steps=50)
dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=8)
bf = make_batch_fn(dc)

def run_steps(mesh, params, opt_state, start, n):
    _, _, jit_for = make_train_step(model, opt, mesh)[0:3]
    step = jit_for(params, jax.tree.map(jnp.asarray, bf(0)))
    losses = []
    for s in range(start, start + n):
        params, opt_state, _, met = step(params, opt_state, None,
                                         jax.tree.map(jnp.asarray, bf(s)))
        losses.append(float(met["loss"]))
    return params, opt_state, losses

# phase 1: 8 devices as (4 data, 2 model)
devs = jax.devices()
mesh1 = Mesh(np.asarray(devs).reshape(4, 2), ("data", "model"))
_, init_fn, _ = make_train_step(model, opt, mesh1)
params, opt_state, _ = init_fn(jax.random.PRNGKey(0))
params, opt_state, l1 = run_steps(mesh1, params, opt_state, 0, 4)
save_checkpoint(ckpt, 4, {"params": params, "opt": opt_state})

# phase 2: lose 4 devices -> remesh survivors, restore, continue
survivors = devs[:4]
mesh2 = elastic_remesh(survivors, model_parallel=2)
assert dict(mesh2.shape) == {"data": 2, "model": 2}, mesh2.shape
ps2 = param_shardings(mesh2, params)
restored, step0 = restore_checkpoint(ckpt, {"params": params,
                                            "opt": opt_state})
# reshard explicitly onto the survivor mesh (mesh-shape-agnostic file)
p2 = jax.tree.map(lambda a, s: jax.device_put(jax.device_get(a), s),
                  restored["params"], ps2)
o2 = jax.tree.map(lambda a: jax.device_put(jax.device_get(a)),
                  restored["opt"])
_, _, l2 = run_steps(mesh2, p2, o2, step0, 3)

# reference: uninterrupted run on mesh1
params, opt_state, _ = init_fn(jax.random.PRNGKey(0))
params, opt_state, r1 = run_steps(mesh1, params, opt_state, 0, 4)
_, _, r2 = run_steps(mesh1, params, opt_state, 4, 3)

print(json.dumps({"l1": l1, "l2": l2, "r2": r2}))
"""


def test_elastic_restart_across_mesh_shapes(tmp_path):
    script = tmp_path / "elastic.py"
    script.write_text(_SCRIPT)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen(
        [sys.executable, str(script), str(tmp_path / "ref_ckpt")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=str(ROOT), env=env)
    try:
        init = str(tmp_path / "init")
        jp = jax_build(jax_config("deepseek-7b", smoke=True)).init(
            jax.random.PRNGKey(0))
        jax_save(init, 0, {"params": jp, "opt": ja.adamw_init(jp)})
        port = run_ranks(cases.elastic_case, 8, init,
                         str(tmp_path / "ckpt"))
        out, err = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err[-3000:]
    want = json.loads(out.strip().splitlines()[-1])
    assert all(p is None for p in port[4:]), "a lost rank kept training"
    got = port[0]
    assert all(p == got for p in port[1:4])
    assert got["mesh1"] == {"data": 4, "model": 2}
    assert got["mesh2"] == {"data": 2, "model": 2}
    assert got["restored_step"] == 4 and got["r1"] == got["l1"]
    for k in ("l1", "l2", "r2"):
        assert len(got[k]) == len(want[k])
        for a, b in zip(got[k], want[k]):
            assert abs(a - b) < REF_TOL, (k, got[k], want[k])
    for a, b in zip(got["l2"], got["r2"]):
        assert abs(a - b) <= SELF_RTOL * abs(b), (got["l2"], got["r2"])
