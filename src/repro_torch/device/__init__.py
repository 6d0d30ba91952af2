"""repro_torch.device: the PIM device-hierarchy simulator.

The port's copy of ``repro.device``. It layers a full chip — crossbars x
banks x bank groups x channels (:class:`DeviceConfig`) — above the
single-crossbar :class:`~repro_torch.engine.Engine`:

* :class:`Coord` / :class:`CoordAllocator` place the block planner's
  co-scheduled groups onto physical crossbar coordinates
  (:func:`repro_torch.pim.planner.plan_block`'s ``placer`` hook), and
  the serve launcher scales its slot budget with
  :attr:`DeviceConfig.n_crossbars`;
* :class:`CommandTrace` / :class:`TraceRecorder` / :func:`block_trace`
  emit, serialize, and bit-exactly replay the host command stream (the
  reference's `docs/trace-format.md`; either package replays the
  other's traces);
* :func:`charge` / :class:`DeviceCostReport` roll the trace up into
  per-level utilization/cost rows, end-to-end latency, and the
  ``capacity(tokens_per_sec) -> n_devices`` fleet-sizing answer.
"""
from .config import (Coord, CoordAllocator, DeviceCapacityError,
                     DeviceConfig)
from .cost import DeviceCostReport, charge
from .trace import CommandTrace, Record, TraceRecorder, block_trace

__all__ = [
    "Coord", "CoordAllocator", "DeviceCapacityError", "DeviceConfig",
    "CommandTrace", "Record", "TraceRecorder", "block_trace",
    "DeviceCostReport", "charge",
]
