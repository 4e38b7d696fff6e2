"""Callback-based logger (reference ``Logger``, src/PaperRenderer/Statistics.h:12-40).

Severity levels, a user-provided sink callback, thread-safe ``record_log``;
the default sink prints to stderr.
"""

from __future__ import annotations

import enum
import sys
import threading
from typing import Callable, Optional


class LogType(enum.IntEnum):
    INFO = 0
    WARNING = 1
    CRITICAL_ERROR = 2


LogCallback = Callable[[LogType, str], None]


def _default_sink(level: LogType, message: str) -> None:
    prefix = {LogType.INFO: "INFO", LogType.WARNING: "WARN",
              LogType.CRITICAL_ERROR: "CRIT"}
    print(f"[paperrenderer-torch {prefix[level]}] {message}", file=sys.stderr)


class Logger:
    def __init__(self, callback: Optional[LogCallback] = None):
        self._callback = callback or _default_sink
        self._lock = threading.Lock()

    def record_log(self, level: LogType, message: str) -> None:
        with self._lock:
            self._callback(level, message)

    def info(self, message: str) -> None:
        self.record_log(LogType.INFO, message)

    def warning(self, message: str) -> None:
        self.record_log(LogType.WARNING, message)

    def critical(self, message: str) -> None:
        self.record_log(LogType.CRITICAL_ERROR, message)
