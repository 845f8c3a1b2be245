"""Structured logging (``vae_latent_geometry_tpu.utils.logging``)."""

from __future__ import annotations

import logging
import sys

_FMT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"


def get_logger(name: str = "vlg", level: int = logging.INFO) -> logging.Logger:
    """A logger writing to stderr; configured once per name."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(_FMT, datefmt="%H:%M:%S"))
        logger.addHandler(h)
        logger.setLevel(level)
        logger.propagate = False
    return logger
