"""Logging for one process.

Port of ``accelerate_tpu/logging.py`` (``MultiProcessAdapter`` :15,
``get_logger`` :57) for one process, which is always the main one: the
``main_process_only`` and ``in_order`` keywords are accepted and have
nothing to order.
"""

from __future__ import annotations

import functools
import logging
import os
from typing import Optional


class MultiProcessAdapter(logging.LoggerAdapter):
    """Drops the reference's per-process keywords; ``warning_once`` logs a
    given warning once per process."""

    def log(self, level, msg, *args, **kwargs):
        if os.environ.get("ACCELERATE_TPU_DISABLE_LOGGING", "false").lower() in ("1", "true"):
            return
        kwargs.pop("main_process_only", None)
        kwargs.pop("in_order", None)
        kwargs.setdefault("stacklevel", 2)
        if self.isEnabledFor(level):
            msg, kwargs = self.process(msg, kwargs)
            self.logger.log(level, msg, *args, **kwargs)

    @functools.lru_cache(None)
    def warning_once(self, *args, **kwargs):
        self.warning(*args, **kwargs)


def get_logger(name: str, log_level: Optional[str] = None) -> MultiProcessAdapter:
    """A logger named ``name``; ``log_level`` (or ``ACCELERATE_TPU_LOG_LEVEL``)
    sets its level and the root's."""
    logger = logging.getLogger(name)
    if log_level is None:
        log_level = os.environ.get("ACCELERATE_TPU_LOG_LEVEL", None)
    if log_level is not None:
        logger.setLevel(log_level.upper())
        logger.root.setLevel(log_level.upper())
    return MultiProcessAdapter(logger, {})
