"""Leveled logger with a last-error latch.

The port's own copy of ``tpufg/utils/logging.py`` (one logger per
package: the port's messages go through this one).

Functional equivalent of the reference's header-only singleton logger
(reference src/logger.hpp:8-73): four levels (DEBUG/INFO/WARNING/ERROR),
wall-clock timestamps, thread-safety, and a "has error / last error" latch
(logger.hpp:39-41) that the engine surfaces at shutdown.

Differences by design: level filtering is honored in the hot loop (the
reference logs per-frame INFO unconditionally, a measured overhead —
scaler.cpp:465-477), and output can be redirected for tests.
"""

from __future__ import annotations

import enum
import sys
import threading
import time
from typing import IO, Optional


class LogLevel(enum.IntEnum):
    DEBUG = 0
    INFO = 1
    WARNING = 2
    ERROR = 3


_LEVEL_NAMES = {
    LogLevel.DEBUG: "DEBUG",
    LogLevel.INFO: "INFO",
    LogLevel.WARNING: "WARNING",
    LogLevel.ERROR: "ERROR",
}


class Logger:
    def __init__(self, level: LogLevel = LogLevel.INFO, stream: Optional[IO] = None):
        self._lock = threading.Lock()
        self.level = level
        # an explicit stream pins output; otherwise resolve sys.stdout /
        # sys.stderr at WRITE time (redirects survive interpreter-level
        # stream swaps — pytest capture, contextlib.redirect_*)
        self.stream = stream
        #: route log lines to stderr — set by the CLI when stdout carries
        #: the y4m payload (--output -)
        self.to_stderr = False
        self._last_error: Optional[str] = None

    def log(self, level: LogLevel, *parts) -> None:
        msg = "".join(str(p) for p in parts)
        with self._lock:
            if level >= LogLevel.ERROR:
                self._last_error = msg
            if level < self.level:
                return
            stream = self.stream
            if stream is None:
                stream = sys.stderr if self.to_stderr else sys.stdout
            ts = time.strftime("%a %b %d %H:%M:%S %Y", time.localtime())
            stream.write(f"[{ts}] [{_LEVEL_NAMES[level]}] {msg}\n")

    # reference macro surface (logger.hpp:70-73)
    def debug(self, *parts) -> None:
        self.log(LogLevel.DEBUG, *parts)

    def info(self, *parts) -> None:
        self.log(LogLevel.INFO, *parts)

    def warning(self, *parts) -> None:
        self.log(LogLevel.WARNING, *parts)

    def error(self, *parts) -> None:
        self.log(LogLevel.ERROR, *parts)

    # last-error latch (logger.hpp:39-41)
    def has_error(self) -> bool:
        with self._lock:
            return self._last_error is not None

    def get_last_error(self) -> Optional[str]:
        with self._lock:
            return self._last_error

    def clear_error(self) -> None:
        with self._lock:
            self._last_error = None


_global_logger = Logger()


def get_logger() -> Logger:
    return _global_logger
