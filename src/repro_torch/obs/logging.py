"""Shared logging setup for launch entry points.

Importing anything under :mod:`repro_torch` never touches global logging
state: entry-point ``main()`` functions opt in by calling
:func:`setup_logging`, which configures only the ``"repro_torch"``
logger subtree (handler attached there, ``propagate=False``) and is
idempotent so every launcher can call it safely. The subtree and its
handler flag are the port's own, apart from the reference package's
``"repro"`` subtree, so in a process that loads both packages setting
up one leaves the other's loggers untouched.
"""
from __future__ import annotations

import logging

__all__ = ["setup_logging", "get_logger"]

_ROOT_NAME = "repro_torch"
_CONFIGURED_FLAG = "_repro_torch_obs_handler"


def setup_logging(level: int = logging.INFO,
                  fmt: str = "%(message)s") -> logging.Logger:
    """Configure the ``"repro_torch"`` logger subtree (idempotent).

    Attaches one stream handler to the ``repro_torch`` logger and stops
    propagation to the root logger; repeat calls only adjust the level.
    Returns the configured logger.
    """
    logger = logging.getLogger(_ROOT_NAME)
    logger.setLevel(level)
    if not getattr(logger, _CONFIGURED_FLAG, False):
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(fmt))
        setattr(handler, _CONFIGURED_FLAG, True)
        logger.addHandler(handler)
        logger.propagate = False
        setattr(logger, _CONFIGURED_FLAG, True)
    return logger


def get_logger(name: str) -> logging.Logger:
    """A logger under the ``repro_torch`` subtree
    (``repro_torch.<name>``)."""
    if name == _ROOT_NAME or name.startswith(_ROOT_NAME + "."):
        return logging.getLogger(name)
    return logging.getLogger(f"{_ROOT_NAME}.{name}")
