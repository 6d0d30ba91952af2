"""repro_torch.train: the serving half of ``repro.train``.

:func:`make_serve_step` and :func:`make_prefill`, the step factories the
launcher's model mode runs. The port serves one unsharded model on one
card, so there are no shardings. Training (``make_train_step``,
checkpoints, the fault runner, sharding) is not ported yet.
"""
from .step import make_prefill, make_serve_step

__all__ = ["make_serve_step", "make_prefill"]
