"""Process-aware logging.

Port of roar_tpu/utils/logging.py: a stdlib logger tagged with the process,
`log_once` dedup, and the level from `ROAR_LOG_LEVEL`.  `process_index` reads
`RANK` (the torch launchers' process rank), 0 when it is unset.
"""

from __future__ import annotations

import logging
import os
import sys
from functools import lru_cache

_FORMAT = "[roar_tpu_torch %(levelname)s %(process)s] %(message)s"


@lru_cache(maxsize=1)
def get_logger(name: str = "roar_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
        logger.propagate = False
    level = os.environ.get("ROAR_LOG_LEVEL", "INFO").upper()
    logger.setLevel(getattr(logging, level, logging.INFO))
    return logger


_seen: set = set()


def log_once(message: str, level: int = logging.INFO) -> None:
    """Log a message only once per process."""
    if message in _seen:
        return
    _seen.add(message)
    get_logger().log(level, message)


def process_index() -> int:
    """This process's rank (`RANK`); 0 when the run is not distributed."""
    try:
        return int(os.environ.get("RANK", "0") or 0)
    except ValueError:
        return 0
