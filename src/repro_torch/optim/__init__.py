"""repro_torch.optim: AdamW and int8 error-feedback gradient compression,
the port's copy of ``repro.optim``."""
from .adamw import (AdamWConfig, OptState, adamw_init, adamw_update,
                    cosine_schedule)
from .compress import compressed_psum, ef_compress_tree, quantize_grad

__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_update",
           "cosine_schedule", "ef_compress_tree", "compressed_psum",
           "quantize_grad"]
