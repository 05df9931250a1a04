"""Leveled logging configured by a JSON option string.

Mirrors the reference's logging contract (SURVEY §2.11, §5): the CLI
takes ``-l '{"level":0}'`` and every module logs timestamped leveled
lines; CRITICAL doubles as the finding event stream (reference
fuzzer/main.c:393-401).

Levels follow the reference's ordering: DEBUG=0 INFO=1 WARNING=2
ERROR=3 CRITICAL=4 FATAL=5 — a configured level N shows messages with
level >= N.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Optional, TextIO

LEVEL_DEBUG = 0
LEVEL_INFO = 1
LEVEL_WARNING = 2
LEVEL_ERROR = 3
LEVEL_CRITICAL = 4
LEVEL_FATAL = 5

_LEVEL_NAMES = ["DEBUG", "INFO", "WARNING", "ERROR", "CRITICAL", "FATAL"]


class _LogState:
    level: int = LEVEL_INFO
    # None = resolve sys.stderr at write time.  Binding the stream at import
    # time makes every later write target whatever stderr was when this
    # module was first imported — under pytest that can be a capture stream
    # that is closed long before the logging call, turning unrelated tests
    # into "I/O operation on closed file" failures depending on collection
    # order.  Only an explicitly configured {"file": ...} stream is pinned.
    stream: Optional[TextIO] = None
    filename: Optional[str] = None
    _fh: Optional[TextIO] = None


_state = _LogState()


def setup_logging(options: Optional[str] = None) -> None:
    """Configure logging from a JSON option string.

    Accepted keys: ``level`` (int 0-5), ``file`` (path; appended to).
    ``None`` or ``""`` keeps defaults (INFO to stderr).
    """
    if not options:
        return
    opts = json.loads(options) if isinstance(options, str) else dict(options)
    if "level" in opts:
        lvl = int(opts["level"])
        if not (LEVEL_DEBUG <= lvl <= LEVEL_FATAL):
            raise ValueError(f"log level out of range: {lvl}")
        _state.level = lvl
    if "file" in opts:
        fh = open(opts["file"], "a", buffering=1)
        if _state._fh is not None:
            _state._fh.close()
        _state._fh = fh
        _state.filename = opts["file"]
        _state.stream = fh


def logging_help() -> str:
    return (
        "Logging options (JSON):\n"
        '  {"level": N}  minimum level shown: 0=DEBUG 1=INFO 2=WARNING '
        "3=ERROR 4=CRITICAL 5=FATAL (default 1)\n"
        '  {"file": "path"}  append log lines to a file instead of stderr\n'
    )


def _log(level: int, fmt: str, *args) -> None:
    if level < _state.level:
        return
    msg = (fmt % args) if args else fmt
    stamp = time.strftime("%Y-%m-%d %H:%M:%S")
    stream = _state.stream if _state.stream is not None else sys.stderr
    try:
        stream.write(f"{stamp} - {_LEVEL_NAMES[level]} - {msg}\n")
    except ValueError:
        # A pinned stream (log file or an inherited redirect) was closed
        # out from under us; fall back to the live stderr rather than
        # turning a log line into a crash.
        if stream is not sys.stderr:
            _state.stream = None
            _state._fh = None
            sys.stderr.write(f"{stamp} - {_LEVEL_NAMES[level]} - {msg}\n")


def DEBUG_MSG(fmt: str, *args) -> None:
    _log(LEVEL_DEBUG, fmt, *args)


def INFO_MSG(fmt: str, *args) -> None:
    _log(LEVEL_INFO, fmt, *args)


def WARNING_MSG(fmt: str, *args) -> None:
    _log(LEVEL_WARNING, fmt, *args)


def ERROR_MSG(fmt: str, *args) -> None:
    _log(LEVEL_ERROR, fmt, *args)


def CRITICAL_MSG(fmt: str, *args) -> None:
    _log(LEVEL_CRITICAL, fmt, *args)


def FATAL_MSG(fmt: str, *args) -> None:
    """Log at FATAL and raise — the reference's FATAL_MSG exits the process."""
    _log(LEVEL_FATAL, fmt, *args)
    raise FatalError((fmt % args) if args else fmt)


class FatalError(RuntimeError):
    """Raised by FATAL_MSG instead of the reference's exit(1)."""


def get_logger():
    """Return the module-level log functions as a namespace-like tuple."""
    return (DEBUG_MSG, INFO_MSG, WARNING_MSG, ERROR_MSG, CRITICAL_MSG,
            FATAL_MSG)


def set_level(level: int) -> None:
    _state.level = level


def get_level() -> int:
    return _state.level
