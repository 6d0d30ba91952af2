"""repro_torch.data: the deterministic synthetic token stream (numpy
only), the port's copy of ``repro.data``."""
from .pipeline import DataConfig, SyntheticStream, make_batch_fn

__all__ = ["DataConfig", "SyntheticStream", "make_batch_fn"]
