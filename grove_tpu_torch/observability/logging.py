"""Structured logging (a zap-like logger).

Counterpart of ``grove_tpu/observability/logging.py``: level and format
(json or text) are configured once on the package's root logger
(``grove_tpu_torch``); loggers carry key-value context, as logr's do.
"""

from __future__ import annotations

import json
import logging
import sys
from typing import Any, Dict, Optional

_LEVELS = {"debug": logging.DEBUG, "info": logging.INFO, "error": logging.ERROR}


class _JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        payload: Dict[str, Any] = {
            "ts": self.formatTime(record),
            "level": record.levelname.lower(),
            "logger": record.name,
            "msg": record.getMessage(),
        }
        payload.update(getattr(record, "kv", {}))
        return json.dumps(payload)


class _TextFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        kv = getattr(record, "kv", {})
        suffix = " ".join(f"{k}={v}" for k, v in kv.items())
        return (
            f"{self.formatTime(record)} {record.levelname:<5}"
            f" {record.name} {record.getMessage()}"
            + (f" {suffix}" if suffix else "")
        )


class Logger:
    """logr-style: .info/.error with trailing key-values, .with_values."""

    def __init__(self, name: str, _kv: Optional[Dict[str, Any]] = None) -> None:
        self._logger = logging.getLogger(name)
        self._kv = dict(_kv or {})

    def with_values(self, **kv: Any) -> "Logger":
        merged = dict(self._kv)
        merged.update(kv)
        return Logger(self._logger.name, merged)

    def _log(self, level: int, msg: str, kv: Dict[str, Any]) -> None:
        merged = dict(self._kv)
        merged.update(kv)
        self._logger.log(level, msg, extra={"kv": merged})

    def debug(self, msg: str, **kv: Any) -> None:
        self._log(logging.DEBUG, msg, kv)

    def info(self, msg: str, **kv: Any) -> None:
        self._log(logging.INFO, msg, kv)

    def error(self, msg: str, **kv: Any) -> None:
        self._log(logging.ERROR, msg, kv)


def configure_logging(level: str = "info", fmt: str = "json") -> None:
    """Install the configured handler on the grove root logger."""
    root = logging.getLogger("grove_tpu_torch")
    root.setLevel(_LEVELS.get(level, logging.INFO))
    root.handlers.clear()
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(_JsonFormatter() if fmt == "json" else _TextFormatter())
    root.addHandler(handler)
    root.propagate = False


def get_logger(name: str) -> Logger:
    return Logger(f"grove_tpu_torch.{name}")
