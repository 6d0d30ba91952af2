"""Device meshes: named axes over the cards of this host.

The port's copy of the host half of ``repro.launch.mesh``. A
:class:`Mesh` takes the place of ``jax.sharding.Mesh`` (and, without
devices, of ``AbstractMesh``): axis names, their sizes, and the devices
laid out over them. The partition rules of
:mod:`repro_torch.train.sharding` read only the names and sizes.

Functions, not module-level constants: importing this module touches no
device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

__all__ = ["Mesh", "abstract_mesh", "make_production_mesh", "make_host_mesh",
           "dp_axes", "tp_axis"]


@dataclass(frozen=True)
class Mesh:
    """Named axes (``axis_names``) of sizes ``axis_sizes`` over
    ``devices`` (a nested tuple shaped as the axes), or over no devices
    (an abstract mesh, for computing specs)."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    devices: Optional[tuple] = None

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"{len(self.axis_sizes)} sizes for "
                             f"{len(self.axis_names)} axis names")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))


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


def make_host_mesh(model_parallel: int = 1) -> Mesh:
    """Whatever this host has: (data, model) over its CUDA cards, or over
    the CPU (one device) when it has none."""
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
