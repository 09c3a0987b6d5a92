"""Leveled logging: the port of ``bluefog_tpu/utils/logging.py``.

The reference's six-level scale (``common/logging.{h,cc}``) and env
contract: ``BLUEFOG_TPU_LOG_LEVEL`` in {trace, debug, info, warn, error,
fatal} (default warn), ``BLUEFOG_TPU_LOG_HIDE_TIME=1`` drops timestamps.
The logger is ``"bluefog_tpu_torch"``, the port's package name, where the
JAX package's is ``"bluefog_tpu"``.  It keeps propagating to the root
logger (the JAX package's stops it), so an application's handlers and
pytest's ``caplog`` see its records; its own stderr handler writes only
while the root logger has no handler, so no line prints twice.
"""

from __future__ import annotations

import logging as _logging
import sys

from bluefog_tpu_torch.utils import config

__all__ = ["get_logger", "TRACE", "LOGGER_NAME"]

LOGGER_NAME = "bluefog_tpu_torch"
TRACE = 5  # below DEBUG: the reference's sixth level
_logging.addLevelName(TRACE, "TRACE")

_LEVELS = {
    "trace": TRACE,
    "debug": _logging.DEBUG,
    "info": _logging.INFO,
    "warn": _logging.WARNING,
    "warning": _logging.WARNING,
    "error": _logging.ERROR,
    "fatal": _logging.CRITICAL,
}

_configured = False


class _StderrUnlessRooted(_logging.StreamHandler):
    """The port's stderr handler, silent while the root logger has a
    handler of its own (the record reaches that one by propagation)."""

    def emit(self, record):
        if not _logging.getLogger().handlers:
            super().emit(record)


def get_logger() -> _logging.Logger:
    """The port's logger, configured once from the environment."""
    global _configured
    logger = _logging.getLogger(LOGGER_NAME)
    if not _configured:
        cfg = config.get()
        logger.setLevel(_LEVELS.get(cfg.log_level, _logging.WARNING))
        if not logger.handlers:
            h = _StderrUnlessRooted(sys.stderr)
            fmt = "%(levelname)s %(name)s: %(message)s" if cfg.log_hide_time \
                else "%(asctime)s %(levelname)s %(name)s: %(message)s"
            h.setFormatter(_logging.Formatter(fmt))
            logger.addHandler(h)
        _configured = True
    return logger
