"""Leveled, ANSI-colored logger with global indentation.

Capability parity with the reference's ``source/Logger.{h,cpp}``: five levels
(0 none, 1 errors/warnings, 2 info, 3 debug, 4 extra-verbose), cyan debug /
red error / yellow warning coloring, and a global indent used to show nested
build phases (Logger.cpp:27-32, LOG_INDENT=4).
"""

from __future__ import annotations

import sys
import time

_COLOR_DEBUG = "\033[36m"  # cyan
_COLOR_ERROR = "\033[31;1m"  # red
_COLOR_WARN = "\033[33m"  # yellow
_COLOR_RESET = "\033[0m"

LOG_INDENT = 4


class Logger:
    """Static logging interface (mirrors reference Logger statics)."""

    level: int = 2
    _indent: int = 0
    stream = sys.stdout

    @classmethod
    def set_level(cls, level: int) -> None:
        cls.level = level

    @classmethod
    def indent(cls, n: int) -> None:
        """Set the global indentation to ``n`` spaces (0 resets)."""
        cls._indent = max(0, n)

    @classmethod
    def _emit(cls, color: str, tag: str, msg: str) -> None:
        pad = " " * cls._indent
        ts = time.strftime("%H:%M:%S")
        cls.stream.write(f"{color}{ts} {tag}{_COLOR_RESET} {pad}{msg}\n")

    @classmethod
    def error(cls, msg: str) -> None:
        if cls.level >= 1:
            cls._emit(_COLOR_ERROR, "EE", msg)

    @classmethod
    def warning(cls, msg: str) -> None:
        if cls.level >= 1:
            cls._emit(_COLOR_WARN, "WW", msg)

    @classmethod
    def info(cls, msg: str) -> None:
        if cls.level >= 2:
            cls._emit("", "II", msg)

    @classmethod
    def debug(cls, msg: str) -> None:
        if cls.level >= 3:
            cls._emit(_COLOR_DEBUG, "DD", msg)

    @classmethod
    def debug_verbose(cls, msg: str) -> None:
        if cls.level >= 4:
            cls._emit(_COLOR_DEBUG, "DV", msg)


def format_bytes(n: int) -> str:
    """Human-readable byte size (reference utils.h:19-35 formatBytes)."""
    units = ["B", "KiB", "MiB", "GiB", "TiB"]
    x = float(n)
    for u in units:
        if x < 1024.0 or u == units[-1]:
            return f"{x:.2f} {u}"
        x /= 1024.0
    return f"{x:.2f} TiB"


class Timer:
    """Wall-clock timer for host-phase reporting (reference used boost ptime)."""

    def __init__(self) -> None:
        self.t0 = time.perf_counter()

    def ms(self) -> float:
        return (time.perf_counter() - self.t0) * 1e3

    def s(self) -> float:
        return time.perf_counter() - self.t0
