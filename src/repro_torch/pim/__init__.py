"""PIM systems integration: quantization, PIMLinear, crossbar planner.

The port's copy of ``repro.pim``, on torch tensors.
"""
from .quant import (QTensor, quantize, dequantize, qmatmul_exact,
                    qragged_matmul_exact)
from .pim_linear import PIMLinearSpec, pim_linear_apply
from .planner import (BlockLinear, BlockPlan, GemmShape, LinearGroup,
                      PIMPlan, ServeSlotPlan, block_linears,
                      gemms_from_config, plan_block, plan_model,
                      plan_serve_slots)

__all__ = ["QTensor", "quantize", "dequantize", "qmatmul_exact",
           "qragged_matmul_exact",
           "PIMLinearSpec", "pim_linear_apply",
           "GemmShape", "PIMPlan", "plan_model", "gemms_from_config",
           "BlockLinear", "LinearGroup", "BlockPlan", "block_linears",
           "plan_block", "ServeSlotPlan", "plan_serve_slots"]
