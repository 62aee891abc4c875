"""`davisinteractive.logging`: the toolkit's logging facade over a stdlib
logger named "davisinteractive", so that the caller's logging
configuration applies (`set_logging_level`, `info`, `warning`, ...)."""

import logging as _logging

_logger = _logging.getLogger("davisinteractive")

__all__ = ["set_logging_level", "set_info_level", "debug", "info",
           "warning", "error"]


def set_logging_level(level: int) -> None:
    """Set the toolkit logger's level (stdlib logging levels)."""
    _logger.setLevel(level)
    if not _logger.handlers:
        _logger.addHandler(_logging.StreamHandler())


def set_info_level() -> None:
    set_logging_level(_logging.INFO)


def debug(msg, *args):
    _logger.debug(msg, *args)


def info(msg, *args):
    _logger.info(msg, *args)


def warning(msg, *args):
    _logger.warning(msg, *args)


def error(msg, *args):
    _logger.error(msg, *args)
