"""Device meshes: named axes over the cards of this host.

The port's copy of the host half of ``repro.launch.mesh``. A
:class:`Mesh` takes the place of ``jax.sharding.Mesh`` (and, without
devices, of ``AbstractMesh``): axis names, their sizes, and the devices
laid out over them. The partition rules of
:mod:`repro_torch.train.sharding` read only the names and sizes; under
a ``torch.distributed`` process group the mesh is laid over the ranks,
one process a rank, and ``comm`` holds this rank's coordinates and the
axes' process groups (:class:`repro_torch.dist.MeshComm`).

Functions, not module-level constants: importing this module touches no
device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import dist

__all__ = ["Mesh", "abstract_mesh", "make_production_mesh", "make_host_mesh",
           "mesh_over_ranks", "dp_axes", "tp_axis"]


@dataclass(frozen=True)
class Mesh:
    """Named axes (``axis_names``) of sizes ``axis_sizes`` over
    ``devices`` (a nested tuple shaped as the axes: devices, or the
    global ranks of a process-group mesh), or over no devices (an
    abstract mesh, for computing specs). ``comm``: this rank's
    :class:`repro_torch.dist.MeshComm` on a process-group mesh, else
    None (one process)."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    devices: Optional[tuple] = None
    comm: Any = field(default=None, compare=False, repr=False)

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"{len(self.axis_sizes)} sizes for "
                             f"{len(self.axis_names)} axis names")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        """The number of devices (ranks) of the mesh."""
        n = 1
        for a in self.axis_sizes:
            n *= a
        return n


def abstract_mesh(axis_sizes: Tuple[int, ...],
                  axis_names: Tuple[str, ...]) -> Mesh:
    """A :class:`Mesh` without devices (the reference's
    ``AbstractMesh``)."""
    return Mesh(tuple(axis_sizes), tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The dry-run's meshes, without devices: 16 x 16 ("data", "model"),
    256 chips, or 2 x 16 x 16 ("pod", "data", "model"), 512 chips."""
    if multi_pod:
        return abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    return abstract_mesh((16, 16), ("data", "model"))


def mesh_over_ranks(axis_sizes: Tuple[int, ...],
                    axis_names: Tuple[str, ...], ranks=None, *,
                    local_sync: bool = False) -> Mesh:
    """A :class:`Mesh` over global ``ranks`` (default: the world's, in
    order) laid out row-major over the axes, with this rank's process
    groups in ``comm`` (None on a rank outside ``ranks``). Needs a running
    process group; see :func:`repro_torch.dist.build_mesh_comm` for who
    must call it."""
    if ranks is None:
        ranks = list(range(dist.world_size()))
    ranks = [int(r) for r in ranks]
    comm = dist.build_mesh_comm(axis_sizes, axis_names, ranks,
                                local_sync=local_sync)
    grid = _grid(ranks, tuple(axis_sizes))
    return Mesh(tuple(axis_sizes), tuple(axis_names), grid, comm)


def _grid(items, sizes):
    if len(sizes) == 1:
        return tuple(items)
    step = len(items) // sizes[0]
    return tuple(_grid(items[i * step:(i + 1) * step], sizes[1:])
                 for i in range(sizes[0]))


def make_host_mesh(model_parallel: int = 1) -> Mesh:
    """Whatever this host has: under a running ``torch.distributed``
    process group, (data, model) over the world's ranks (one process a
    rank, each on :func:`repro_torch.dist.local_device`); without one,
    (data, model) over this host's CUDA cards, or over the CPU (one
    device) when it has none."""
    if dist.is_initialized():
        n = dist.world_size()
        if model_parallel < 1 or n % model_parallel:
            raise ValueError(f"model_parallel {model_parallel} does not "
                             f"divide the world of {n} rank(s)")
        return mesh_over_ranks((n // model_parallel, model_parallel),
                               ("data", "model"))
    if torch.cuda.is_available():
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [torch.device("cpu")]
    n = len(devices)
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"model_parallel {model_parallel} does not divide "
                         f"the {n} device(s) of this host")
    dp = n // model_parallel
    grid = tuple(tuple(devices[i * model_parallel:(i + 1) * model_parallel])
                 for i in range(dp))
    return Mesh((dp, model_parallel), ("data", "model"), grid)


def dp_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The data-parallel axes of ``mesh`` ("pod", "data"), in order."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def tp_axis(mesh: Mesh) -> Optional[str]:
    """The model-parallel axis name, or None."""
    return "model" if "model" in mesh.axis_names else None
