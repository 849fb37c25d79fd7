"""Shared logger (port of ``dlrover_tpu/common/log.py``)."""

import logging
import os
import sys

_FORMAT = "[%(asctime)s] [%(levelname)s] [%(name)s:%(lineno)d] %(message)s"


def _build_logger() -> logging.Logger:
    logger = logging.getLogger("dlrover_tpu_torch")
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
        level = os.environ.get("DLROVER_TPU_LOG_LEVEL", "INFO").upper()
        if level not in logging._nameToLevel:
            level = "INFO"
        logger.setLevel(level)
        logger.propagate = False
    return logger


default_logger = _build_logger()


def get_logger(name: str = "") -> logging.Logger:
    if not name:
        return default_logger
    return default_logger.getChild(name)
