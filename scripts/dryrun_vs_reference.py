"""The port's dry-run records against the reference's compiled sharded
serve step, for the smoke decode cells on a (1, 2) mesh.

For each architecture's smoke config, batch 4 against a cache of 32:

* the reference: ``repro.train.step.make_serve_step(model, mesh)``'s
  ``jit_for(...).lower(...).compile()`` over two forced host devices,
  as ``repro.launch.dryrun.lower_cell`` lowers a decode cell, its
  collectives summed from the compiled HLO text (the output operand of
  each, by kind) and XLA's ``bytes accessed``;
* the port: ``repro_torch.launch.dryrun.cell_record`` on the abstract
  (1, 2) mesh (rank 0's sharded step traced in a fake world).

GSPMD chooses its own collectives and fuses what it can, where the port
calls Megatron's layout by hand and counts eager operators, so the
numbers are a comparison to read, not to gate. Prints one JSON object a
line, then a markdown table. Run from the repo root, on the host::

  PYTHONPATH=src python scripts/dryrun_vs_reference.py [arch ...]
"""
from __future__ import annotations

import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import json  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.configs import ARCHS  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.train import make_serve_step  # noqa: E402
from repro.train.sharding import (batch_shardings,  # noqa: E402
                                  param_shardings, state_shardings)
from repro_torch.configs import ShapeSpec, get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import abstract_mesh  # noqa: E402

BATCH, CACHE = 4, 32


def _sharded(tree, shardings):
    return jax.tree.map(lambda s, sh: jax.ShapeDtypeStruct(
        s.shape, s.dtype, sharding=sh), tree, shardings)


def reference(arch: str) -> dict:
    """The reference's compiled decode step on (1, 2): its collectives
    and bytes accessed."""
    model = jax_build(jax_config(arch, smoke=True))
    mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(1, 2),
                ("data", "model"))
    params = jax.eval_shape(lambda k: model.init(k, jnp.bfloat16),
                            jax.random.PRNGKey(0))
    params = _sharded(params, param_shardings(mesh, params))
    states = jax.eval_shape(lambda: model.init_decode_state(
        BATCH, CACHE, jnp.bfloat16))
    states = _sharded(states, state_shardings(mesh, states))
    tok = jax.ShapeDtypeStruct((BATCH, 1), jnp.int32)
    bs = batch_shardings(mesh, {"token": tok, "position": tok})
    batch = {k: jax.ShapeDtypeStruct(tok.shape, tok.dtype, sharding=v)
             for k, v in bs.items()}
    _, jit_for = make_serve_step(model, mesh)
    compiled = jit_for(params, states, batch).lower(
        params, states, batch["token"], batch["position"]).compile()
    cost = compiled.cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0] if cost else {}
    return {"collective_bytes": dryrun.collective_bytes(compiled.as_text()),
            "bytes_accessed": float((cost or {}).get("bytes accessed", -1))}


def port(arch: str) -> dict:
    """The port's record of the same cell: rank 0 of (1, 2)."""
    rec = dryrun.cell_record(get_config(arch, smoke=True),
                             ShapeSpec("decode_s", CACHE, BATCH, "decode"),
                             abstract_mesh((1, 2), ("data", "model")))
    return {"collective_bytes": rec["collective_bytes"],
            "bytes_accessed": rec["bytes_accessed"]}


def main(archs) -> None:
    rows = []
    for arch in archs:
        row = {"arch": arch, "reference": reference(arch),
               "port": port(arch)}
        print(json.dumps(row), flush=True)
        rows.append(row)
    print("| arch | reference collectives (bytes) | port collectives "
          "(bytes) | reference bytes accessed | port bytes accessed |")
    print("|---|---|---|---|---|")
    for r in rows:
        ref, mine = r["reference"], r["port"]
        print(f"| {r['arch']} | {ref['collective_bytes']} | "
              f"{mine['collective_bytes']} | {ref['bytes_accessed']:.0f} | "
              f"{mine['bytes_accessed']:.0f} |")


if __name__ == "__main__":
    main(sys.argv[1:] or sorted(ARCHS))
