"""repro_torch.device — the device hierarchy's shape and coordinates.

The port's copy of ``repro.device.config`` only: :class:`DeviceConfig`
(channels x bank groups x banks x crossbars, ``--device-config``'s
``CxGxBxX`` syntax), :class:`Coord`, :class:`CoordAllocator` and
:class:`DeviceCapacityError`. The serve launcher scales its slot budget
with :attr:`DeviceConfig.n_crossbars`, and the block planner's placers
raise :class:`DeviceCapacityError`. The reference's command traces
(``repro.device.trace``) and hierarchical cost model
(``repro.device.cost``) are not ported yet.
"""
from .config import Coord, CoordAllocator, DeviceCapacityError, DeviceConfig

__all__ = ["Coord", "CoordAllocator", "DeviceCapacityError", "DeviceConfig"]
