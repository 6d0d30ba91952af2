"""repro_torch.configs: the model zoo's architecture configs.

The port's copy of ``repro.configs``: ten published architectures as
plain :class:`ModelConfig` dataclasses (:data:`ARCHS`,
:func:`get_config`) and the assigned input shapes. The block planner
(:func:`repro_torch.pim.planner.plan_block`) and the device traces
(:func:`repro_torch.device.block_trace`) read them.
"""
from .base import ModelConfig, MoEConfig
from .registry import ARCHS, get_config
from .shapes import SHAPES, ShapeSpec, cells_for, all_cells, shape_applicable

__all__ = ["ModelConfig", "MoEConfig", "ARCHS", "get_config",
           "SHAPES", "ShapeSpec", "cells_for", "all_cells",
           "shape_applicable"]
