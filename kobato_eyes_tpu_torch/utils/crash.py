"""Crash observability: faulthandler dumps + exception hooks to a crash log.

Counterpart of the reference's crash plumbing (``ui/app.py:122-178``):
faulthandler for hard faults, sys/threading excepthooks appending structured
tracebacks to ``crash.log`` — headless edition (no Qt message boxes).
"""

from __future__ import annotations

import faulthandler
import logging
import sys
import threading
import traceback
from pathlib import Path

logger = logging.getLogger(__name__)

_crash_file = None  # keep the handle alive for faulthandler


def install_crash_handlers(log_dir: str | Path) -> Path:
    """Enable faulthandler + excepthooks writing to <log_dir>/crash.log."""
    global _crash_file
    log_path = Path(log_dir) / "crash.log"
    log_path.parent.mkdir(parents=True, exist_ok=True)
    _crash_file = open(log_path, "a", encoding="utf-8")  # noqa: SIM115
    faulthandler.enable(file=_crash_file, all_threads=True)

    def _write(kind: str, exc_type, exc, tb) -> None:
        try:
            _crash_file.write(f"\n=== {kind} ===\n")
            traceback.print_exception(exc_type, exc, tb, file=_crash_file)
            _crash_file.flush()
        except OSError:
            pass
        logger.critical("%s: %s", kind, exc, exc_info=(exc_type, exc, tb))

    prev_hook = sys.excepthook

    def excepthook(exc_type, exc, tb):
        _write("unhandled exception", exc_type, exc, tb)
        prev_hook(exc_type, exc, tb)

    sys.excepthook = excepthook

    def thread_hook(args: threading.ExceptHookArgs) -> None:
        _write(f"thread {args.thread.name if args.thread else '?'} exception",
               args.exc_type, args.exc_value, args.exc_traceback)

    threading.excepthook = thread_hook
    return log_path
