"""Structured logging.

The reference prints startup parameters and data-loading progress to stdout
(moon_renderer.py:738-754, data_loader.py:141-186); this module adds a
structured logger on top (SURVEY.md section 5 observability note) while
keeping the plain-stdout behavior readable.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time

_LOGGER = None


def get_logger() -> logging.Logger:
    global _LOGGER
    if _LOGGER is None:
        logger = logging.getLogger("moonrtx_tpu_torch")
        level = os.environ.get("MOONRTX_TPU_LOG", "INFO").upper()
        logger.setLevel(level)
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(handler)
        logger.propagate = False
        _LOGGER = logger
    return _LOGGER


def log_event(event: str, **fields) -> None:
    """One JSON event line (machine-readable observability)."""
    get_logger().info(json.dumps({"event": event, "t": time.time(), **fields}))
