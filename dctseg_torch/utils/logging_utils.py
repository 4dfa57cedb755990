"""Logging setup: file + console, as the reference's ``log_args``.  In a
process group only the primary rank logs everything and writes the file;
the others log warnings and errors to the console."""

from __future__ import annotations

import logging
import os
from typing import Optional

LOGGER = "dctseg_torch"


def setup_logging(log_file: Optional[str] = None,
                  level: int = logging.DEBUG) -> logging.Logger:
    from dctseg_torch.parallel.distributed import is_primary
    logger = logging.getLogger(LOGGER)
    primary = is_primary()
    logger.setLevel(level if primary else logging.WARNING)
    logger.propagate = False
    if logger.handlers:
        return logger
    fmt = logging.Formatter("%(asctime)s ===> %(message)s",
                            datefmt="%Y-%m-%d %H:%M:%S")
    ch = logging.StreamHandler()
    ch.setFormatter(fmt)
    logger.addHandler(ch)
    if log_file and primary:
        os.makedirs(os.path.dirname(os.path.abspath(log_file)),
                    exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger
