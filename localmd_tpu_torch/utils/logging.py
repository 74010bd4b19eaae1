"""Stage banners (counterpart of localmd_tpu/utils/logging.py)."""

from __future__ import annotations

import logging
import sys
import time

_LOGGER_NAME = "localmd_tpu_torch"


def get_logger() -> logging.Logger:
    logger = logging.getLogger(_LOGGER_NAME)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(
            logging.Formatter(
                "[%(asctime)s localmd_tpu_torch]: %(message)s", "%y-%m-%d %H:%M:%S"
            )
        )
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


def display(msg: str) -> None:
    """Timestamped stage banner."""
    get_logger().info(msg)


class StageTimer:
    """Context manager that logs the wall-clock duration of a pipeline stage
    (utils/logging.py:37-56)."""

    def __init__(self, name: str, verbose: bool = True):
        self.name = name
        self.verbose = verbose
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        if self.verbose:
            display(f"{self.name}...")
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        if self.verbose:
            display(f"{self.name} done in {self.elapsed:.3f}s")
        return False
