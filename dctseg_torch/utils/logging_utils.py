"""Logging setup: file + console, as the reference's ``log_args``.
Multi-process programs pass ``log_file=None`` on non-primary processes
(console only)."""

from __future__ import annotations

import logging
import os
from typing import Optional

LOGGER = "dctseg_torch"


def setup_logging(log_file: Optional[str] = None,
                  level: int = logging.DEBUG) -> logging.Logger:
    logger = logging.getLogger(LOGGER)
    logger.setLevel(level)
    logger.propagate = False
    if logger.handlers:
        return logger
    fmt = logging.Formatter("%(asctime)s ===> %(message)s",
                            datefmt="%Y-%m-%d %H:%M:%S")
    ch = logging.StreamHandler()
    ch.setFormatter(fmt)
    logger.addHandler(ch)
    if log_file:
        os.makedirs(os.path.dirname(os.path.abspath(log_file)),
                    exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger
