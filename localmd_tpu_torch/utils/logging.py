"""Stage banners (counterpart of localmd_tpu/utils/logging.py)."""

from __future__ import annotations

import logging
import sys

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
