"""Logging shim mirroring LightGBM's ``Log`` class.

Reference: include/LightGBM/utils/log.h (UNVERIFIED — empty mount, see
SURVEY.md banner): four levels (Fatal/Warning/Info/Debug) gated by the
``verbosity`` config param, plus a registerable callback so the host
language owns the sink (LGBM_RegisterLogCallback).
"""
from __future__ import annotations

import sys
from typing import Callable, Optional

# verbosity semantics match LightGBM: <0 fatal only, 0 += warning,
# 1 += info (default), >1 += debug.
_FATAL = -1
_WARNING = 0
_INFO = 1
_DEBUG = 2

_verbosity: int = 1
_callback: Optional[Callable[[str], None]] = None


class LightGBMError(Exception):
    """Error raised by the framework (mirrors lightgbm.basic.LightGBMError)."""


def set_verbosity(level: int) -> None:
    global _verbosity
    _verbosity = int(level)


def get_verbosity() -> int:
    return _verbosity


def register_callback(cb: Optional[Callable[[str], None]]) -> None:
    """Route log lines to ``cb`` instead of stderr (None restores stderr)."""
    global _callback
    _callback = cb


def _emit(msg: str) -> None:
    if _callback is not None:
        _callback(msg)
    else:
        print(msg, file=sys.stderr, flush=True)


def debug(msg: str) -> None:
    if _verbosity >= _DEBUG:
        _emit(f"[LightGBM-Torch] [Debug] {msg}")


def info(msg: str) -> None:
    if _verbosity >= _INFO:
        _emit(f"[LightGBM-Torch] [Info] {msg}")


def warning(msg: str) -> None:
    if _verbosity >= _WARNING:
        _emit(f"[LightGBM-Torch] [Warning] {msg}")


def fatal(msg: str) -> None:
    """Log and raise — mirrors Log::Fatal which throws std::runtime_error."""
    raise LightGBMError(msg)
