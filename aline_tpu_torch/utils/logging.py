"""Console and file logging (``aline_tpu/utils/logging.py``, without the
colours)."""
from __future__ import annotations

import functools
import logging
import os
import sys
import time


@functools.lru_cache(maxsize=None)
def create_logger(log_dir: str | None = None, name: str = "aline_tpu_torch",
                  level: int = logging.INFO) -> logging.Logger:
    """A logger (cached by its arguments) writing to stderr and, with
    ``log_dir``, to a timestamped file there."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.propagate = False
    fmt = logging.Formatter("[%(asctime)s %(name)s %(levelname)s] "
                            "%(message)s", datefmt="%H:%M:%S")
    if not logger.handlers:
        console = logging.StreamHandler(sys.stderr)
        console.setFormatter(fmt)
        logger.addHandler(console)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        stamp = time.strftime("%Y-%m-%d_%H-%M-%S")
        fh = logging.FileHandler(os.path.join(log_dir, f"{name}_{stamp}.log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger
