"""Logging: the package logger (counterpart of ``gwen_tpu.logging_utils``,
cut to what the CLI uses; console only)."""

from __future__ import annotations

import logging

_LOGGER_NAME = "gwen_tpu_torch"


def get_logger() -> logging.Logger:
    return logging.getLogger(_LOGGER_NAME)


def setup_logger(level: int = logging.INFO) -> logging.Logger:
    """Give the package logger (once) a console handler on stderr."""
    logger = get_logger()
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)-7s %(name)s: %(message)s", "%H:%M:%S"))
        logger.addHandler(handler)
        logger.setLevel(level)
        logger.propagate = False
    return logger
