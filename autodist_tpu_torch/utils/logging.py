"""Framework logger.

Parity with reference ``autodist/utils/logging.py:33-106``: a dedicated logger with a
``[PID#...:time:file#Lline:LEVEL]`` format, dual handlers (file under the working dir's
``logs/`` plus stderr), and verbosity taken from ``AUTODIST_MIN_LOG_LEVEL``.
"""

import logging as _pylogging
import os
import sys
import time

from autodist_tpu_torch import const

_LOGGER_NAME = "autodist_tpu_torch"
_FORMAT = "[PID%(process)d %(asctime)s %(filename)s#L%(lineno)d:%(levelname)s] %(message)s"

_logger = None


def _get_logger() -> _pylogging.Logger:
    global _logger
    if _logger is not None:
        return _logger
    logger = _pylogging.getLogger(_LOGGER_NAME)
    logger.propagate = False
    level = const.ENV.AUTODIST_MIN_LOG_LEVEL.val.upper()
    logger.setLevel(level)
    fmt = _pylogging.Formatter(_FORMAT)

    stream = _pylogging.StreamHandler(sys.stderr)
    stream.setFormatter(fmt)
    logger.addHandler(stream)

    try:
        os.makedirs(const.DEFAULT_LOG_DIR, exist_ok=True)
        path = os.path.join(const.DEFAULT_LOG_DIR, f"{int(time.time())}.log")
        fileh = _pylogging.FileHandler(path)
        fileh.setFormatter(fmt)
        logger.addHandler(fileh)
    except OSError:  # read-only filesystem etc. — stderr still works
        pass

    _logger = logger
    return logger


def set_verbosity(level):
    _get_logger().setLevel(level)


def debug(msg, *args, **kwargs):
    _get_logger().debug(msg, *args, **kwargs)


def info(msg, *args, **kwargs):
    _get_logger().info(msg, *args, **kwargs)


def warning(msg, *args, **kwargs):
    _get_logger().warning(msg, *args, **kwargs)


def error(msg, *args, **kwargs):
    _get_logger().error(msg, *args, **kwargs)
