"""Logging: the package logger (counterpart of ``gwen_tpu.logging_utils``,
cut to what the CLI uses)."""

from __future__ import annotations

import logging

_LOGGER_NAME = "gwen_tpu_torch"


def get_logger() -> logging.Logger:
    return logging.getLogger(_LOGGER_NAME)
