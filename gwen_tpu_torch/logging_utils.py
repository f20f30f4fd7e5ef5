"""Logging and warning hygiene: counterpart of ``gwen_tpu.logging_utils``.

``setup_logger()`` builds the package logger once, with a console handler
(DEBUG) and a ``logfile.log`` file handler (INFO) on rank 0 only; every
other rank gets a ``NullHandler``, so a run of N processes prints each line
once. ``suppress_warnings()`` filters noisy third-party warnings.

The rank is ``torch.distributed.get_rank()`` once a process group exists;
before that (``setup_logger`` runs before ``init_process_group``) it is the
``RANK`` that ``python -m torch.distributed.run`` sets, and 0 without one.
"""

from __future__ import annotations

import logging
import os
import warnings
from pathlib import Path

_LOGGER_NAME = "gwen_tpu_torch"


def _rank() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", 0))


def setup_logger(
    log_file: str | Path = "logfile.log",
    console_level: int = logging.DEBUG,
    file_level: int = logging.INFO,
    force: bool = False,
) -> logging.Logger:
    """Create (once, or again with ``force``) the package logger; its
    handlers only on rank 0. A file that cannot be opened (a read-only
    directory) leaves the console handler alone."""
    logger = get_logger()
    if logger.handlers and not force:
        return logger
    for handler in list(logger.handlers):
        logger.removeHandler(handler)
        handler.close()
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    if _rank() == 0:
        fmt = logging.Formatter(
            "%(asctime)s %(levelname)-7s %(name)s: %(message)s", "%H:%M:%S")
        console = logging.StreamHandler()
        console.setLevel(console_level)
        console.setFormatter(fmt)
        logger.addHandler(console)
        try:
            file = logging.FileHandler(log_file)
        except OSError:
            pass
        else:
            file.setLevel(file_level)
            file.setFormatter(fmt)
            logger.addHandler(file)
    else:
        logger.addHandler(logging.NullHandler())
    return logger


def get_logger() -> logging.Logger:
    return logging.getLogger(_LOGGER_NAME)


def suppress_warnings() -> None:
    """Silence matplotlib's deprecation and user warnings, as the
    reference does. The reference also filters JAX's "experimental"
    warnings; the port imports no JAX, so that filter has no counterpart."""
    warnings.filterwarnings("ignore", category=DeprecationWarning, module="matplotlib.*")
    warnings.filterwarnings("ignore", category=UserWarning, module="matplotlib.*")
