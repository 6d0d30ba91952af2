"""The plain reference of the benchmark's models, in plain PyTorch.

It imports nothing but ``torch``: neither JAX, nor the JAX package, nor
anything of the port. See :mod:`reference.model`.
"""
from .model import Reference, reference_config

__all__ = ["Reference", "reference_config"]
