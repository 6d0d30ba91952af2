"""Shared logging setup for launch entry points.

``launch/serve.py`` used to call ``logging.basicConfig`` at module
import, which mutates the *root* logger for any process that merely
imports it (tests, notebooks, library users). The rule now: importing
anything under :mod:`repro` never touches global logging state;
entry-point ``main()`` functions opt in by calling
:func:`setup_logging`, which configures only the ``"repro"`` logger
subtree (handler attached there, ``propagate=False``) and is idempotent
so serve/train/dryrun can each call it safely.
"""
from __future__ import annotations

import logging

__all__ = ["setup_logging", "get_logger"]

_ROOT_NAME = "repro"
_CONFIGURED_FLAG = "_repro_obs_handler"


def setup_logging(level: int = logging.INFO,
                  fmt: str = "%(message)s") -> logging.Logger:
    """Configure the ``"repro"`` logger subtree (idempotent).

    Attaches one stream handler to the ``repro`` logger and stops
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
    """A logger under the ``repro`` subtree (``repro_torch.<name>``)."""
    if name == _ROOT_NAME or name.startswith(_ROOT_NAME + "."):
        return logging.getLogger(name)
    return logging.getLogger(f"{_ROOT_NAME}.{name}")
