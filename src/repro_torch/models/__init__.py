"""Model zoo: layers, blocks, assembly, public API.

The port's copy of ``repro.models``, in plain torch over nested dicts of
parameters (the reference's layout: ``embed``, ``final_norm``,
``prefix``, ``scan`` stacked along a leading axis, ``suffix``,
``encoder``, ``patch_proj``). Every linear of the PIM scopes runs through
the :class:`repro_torch.engine.Engine` the model is built on.
"""
from .model import Model, build_model, input_specs
from .transformer import (decode_step, forward, init_decode_state,
                          init_params, stack_plan)

__all__ = ["Model", "build_model", "input_specs", "forward", "decode_step",
           "init_params", "init_decode_state", "stack_plan"]
