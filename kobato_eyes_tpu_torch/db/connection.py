"""Connection management: PRAGMA policy + process-wide quiesce gate.

The quiesce gate replicates the reference's exclusive-writer discipline
(``src/db/connection.py:25-59``): while a bulk write is in flight, new
connections block (or fail fast), so unsafe-pragma phases never interleave
with readers.  In the TPU engine this same gate marks the window during
which a new device index epoch is being built before its atomic swap.
"""

from __future__ import annotations

import contextlib
import logging
import sqlite3
import threading
import time
from pathlib import Path
from typing import Iterator

from kobato_eyes_tpu_torch.db.schema import ensure_schema

logger = logging.getLogger(__name__)

_QUIESCE_LOCK = threading.Lock()
_QUIESCE_EVENT = threading.Event()  # set => quiesced (no new connections)
_QUIESCE_OWNER: int | None = None

_BOOTSTRAPPED: set[str] = set()
_BOOTSTRAP_LOCK = threading.Lock()


class QuiesceError(RuntimeError):
    """Raised when a connection is requested during an exclusive write phase."""


def begin_quiesce() -> None:
    global _QUIESCE_OWNER
    with _QUIESCE_LOCK:
        if _QUIESCE_EVENT.is_set():
            raise QuiesceError("already quiesced")
        _QUIESCE_OWNER = threading.get_ident()
        _QUIESCE_EVENT.set()


def end_quiesce() -> None:
    global _QUIESCE_OWNER
    with _QUIESCE_LOCK:
        _QUIESCE_OWNER = None
        _QUIESCE_EVENT.clear()


def is_quiesced() -> bool:
    return _QUIESCE_EVENT.is_set()


@contextlib.contextmanager
def quiesced() -> Iterator[None]:
    begin_quiesce()
    try:
        yield
    finally:
        end_quiesce()


def _apply_pragmas(conn: sqlite3.Connection, *, unsafe_fast: bool = False) -> None:
    """Reader/writer PRAGMAs (reference db/connection.py:166-189) or the
    unsafe-fast bulk profile (services/db_writing_lifecycle.py:27-57)."""
    conn.execute("PRAGMA foreign_keys = ON")
    conn.execute("PRAGMA busy_timeout = 30000")
    if unsafe_fast:
        try:
            # eager exclusive lock (reference db_writing_lifecycle.py:27-57);
            # a concurrent holder degrades us to the WAL profile instead of
            # failing the run (reference db_writing.py:235-257 fallback).
            # Probe with a short busy timeout — waiting out the full 30s
            # would stall writer startup behind any long reader.
            conn.execute("PRAGMA busy_timeout = 1000")
            conn.execute("PRAGMA locking_mode = EXCLUSIVE")
            conn.execute("BEGIN IMMEDIATE")
            conn.execute("COMMIT")
            conn.execute("PRAGMA busy_timeout = 30000")
            conn.execute("PRAGMA journal_mode = MEMORY")
            conn.execute("PRAGMA synchronous = OFF")
            conn.execute("PRAGMA temp_store = MEMORY")
        except sqlite3.OperationalError:
            logger.warning("unsafe-fast exclusive lock unavailable; using WAL profile")
            try:
                conn.execute("ROLLBACK")
            except sqlite3.OperationalError:
                pass
            conn.execute("PRAGMA busy_timeout = 30000")
            conn.execute("PRAGMA locking_mode = NORMAL")
            conn.execute("PRAGMA journal_mode = WAL")
            conn.execute("PRAGMA synchronous = NORMAL")
    else:
        conn.execute("PRAGMA journal_mode = WAL")
        conn.execute("PRAGMA synchronous = NORMAL")
    conn.execute("PRAGMA cache_size = -200000")  # 200 MB page cache
    conn.execute("PRAGMA mmap_size = 1073741824")


def connect(
    db_path: str | Path,
    *,
    unsafe_fast: bool = False,
    bypass_quiesce: bool = False,
    wait_timeout: float | None = 0.0,
) -> sqlite3.Connection:
    """Open a catalog connection.

    During a quiesce window non-owner callers either fail fast
    (``wait_timeout=0``), wait up to ``wait_timeout`` seconds, or wait
    forever (``wait_timeout=None``).
    """
    if _QUIESCE_EVENT.is_set() and not bypass_quiesce:
        if _QUIESCE_OWNER != threading.get_ident():
            if wait_timeout == 0.0:
                raise QuiesceError("database is quiesced for an exclusive write")
            deadline = None if wait_timeout is None else time.monotonic() + wait_timeout
            while _QUIESCE_EVENT.is_set():
                if deadline is not None and time.monotonic() >= deadline:
                    raise QuiesceError("timed out waiting for quiesce to end")
                time.sleep(0.01)
    conn = sqlite3.connect(str(db_path), timeout=30.0, check_same_thread=False)
    conn.row_factory = sqlite3.Row
    _apply_pragmas(conn, unsafe_fast=unsafe_fast)
    return conn


def bootstrap(db_path: str | Path) -> sqlite3.Connection:
    """Open + ensure schema; schema creation runs once per path per process."""
    key = str(Path(db_path).absolute())
    conn = connect(db_path, bypass_quiesce=True)
    with _BOOTSTRAP_LOCK:
        if key not in _BOOTSTRAPPED:
            ensure_schema(conn)
            _BOOTSTRAPPED.add(key)
        else:
            ensure_schema(conn)  # idempotent; cheap when current
    return conn


def reset_bootstrap_cache() -> None:
    with _BOOTSTRAP_LOCK:
        _BOOTSTRAPPED.clear()
