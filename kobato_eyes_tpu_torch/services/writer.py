"""Asynchronous catalog writer: queue-fed daemon thread with backpressure.

Behavioral parity with the reference's ``DBWritingService``
(``src/services/db_writing.py:29-442``): bounded queue (default 1024),
flush chunks of 1024, unsafe-fast vs standard write profiles, worker
exception capture re-raised at the caller via ``raise_if_failed``, stop
sentinel with final flush, and a ready event so callers can fail fast when
the writer can't start.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from pathlib import Path

from kobato_eyes_tpu_torch.core.pipeline.contracts import WriteFlush, WriteItem, WriteStop
from kobato_eyes_tpu_torch.db.connection import connect
from kobato_eyes_tpu_torch.db.repository import (
    TaggingItem,
    upsert_embeddings,
    upsert_signatures,
    write_tagging_batch,
)

logger = logging.getLogger(__name__)


class WriterError(RuntimeError):
    """A failure captured on the writer thread, re-raised to the caller."""


class CatalogWriter:
    """Daemon writer thread consuming WriteItem / WriteFlush / WriteStop."""

    def __init__(
        self,
        db_path: str | Path,
        *,
        queue_size: int = 1024,
        flush_chunk: int = 1024,
        unsafe_fast: bool = True,
        ready_timeout: float = 30.0,
    ) -> None:
        self._db_path = Path(db_path)
        self._queue: queue.Queue = queue.Queue(maxsize=queue_size)
        self._flush_chunk = flush_chunk
        self._unsafe_fast = unsafe_fast
        self._ready = threading.Event()
        self._ready_timeout = ready_timeout
        self._failure: BaseException | None = None
        self._thread: threading.Thread | None = None
        self.items_written = 0
        self.embeddings_written = 0
        self.signatures_written = 0
        self.flushes = 0

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("writer already started")
        self._thread = threading.Thread(target=self._run, name="catalog-writer", daemon=True)
        self._thread.start()
        if not self._ready.wait(self._ready_timeout):
            raise WriterError("catalog writer failed to become ready")
        self.raise_if_failed()

    def stop(self, *, flush: bool = True, timeout: float = 120.0) -> None:
        import time as _time

        if self._thread is None:
            return
        deadline = _time.monotonic() + timeout
        # a dead writer never drains the queue; don't block on the sentinel
        while self._thread.is_alive():
            try:
                self._queue.put(WriteStop(flush=flush), timeout=0.25)
                break
            except queue.Full:
                if self._failure is not None or _time.monotonic() >= deadline:
                    break
        self._thread.join(max(0.0, deadline - _time.monotonic()))
        if self._thread.is_alive() and self._failure is None:
            raise WriterError("catalog writer did not stop in time")
        self._thread = None
        self.raise_if_failed()

    def raise_if_failed(self) -> None:
        if self._failure is not None:
            raise WriterError("catalog writer failed") from self._failure

    # -- producer API ------------------------------------------------------

    def put(self, item: WriteItem, *, timeout: float | None = None) -> None:
        """Enqueue with backpressure; never blocks forever on a dead writer.

        A failed writer thread stops draining the queue — a plain blocking
        put would deadlock the producer, so block in short slices and
        re-check the failure flag (reference db_writing.py backpressure +
        raise_if_failed discipline).
        """
        import time as _time

        deadline = None if timeout is None else _time.monotonic() + timeout
        while True:
            self.raise_if_failed()
            try:
                self._queue.put(item, timeout=0.25)
                return
            except queue.Full:
                if deadline is not None and _time.monotonic() >= deadline:
                    raise WriterError("catalog writer queue full (timeout)") from None

    def flush(self) -> None:
        """Request a flush; same dead-writer protection as put()."""
        while True:
            self.raise_if_failed()
            try:
                self._queue.put(WriteFlush(), timeout=0.25)
                return
            except queue.Full:
                continue

    # -- worker ------------------------------------------------------------

    def _run(self) -> None:
        try:
            conn = connect(self._db_path, unsafe_fast=self._unsafe_fast, bypass_quiesce=True)
        except BaseException as exc:  # noqa: BLE001
            self._failure = exc
            self._ready.set()
            return
        self._ready.set()
        buffer: list[WriteItem] = []
        # writer-lifetime tag-def cache (reference StandardBatchWriter)
        self._tag_cache: dict[str, int] = {}
        self._flushes_since_passive = 0
        self._flushes_since_truncate = 0
        try:
            while True:
                try:
                    msg = self._queue.get(timeout=0.5)
                except queue.Empty:
                    # idle housekeeping (reference db_writing.py:369-394):
                    # TRUNCATE checkpoint + optimize every 32 flushes
                    self._idle_maintenance(conn)
                    continue
                if isinstance(msg, WriteItem):
                    buffer.append(msg)
                    if len(buffer) >= self._flush_chunk:
                        self._flush(conn, buffer)
                        self._checkpoint_cadence(conn)
                elif isinstance(msg, WriteFlush):
                    self._flush(conn, buffer)
                    self._checkpoint_cadence(conn)
                elif isinstance(msg, WriteStop):
                    if msg.flush:
                        self._flush(conn, buffer)
                    break
        except BaseException as exc:  # noqa: BLE001
            # Failure policy: capture, surface via raise_if_failed — callers
            # must see writer failures (reference db_writing.py:107-111).
            self._failure = exc
            logger.exception("catalog writer failed")
        finally:
            try:
                conn.close()
            except Exception:  # noqa: BLE001
                pass

    def _checkpoint_cadence(self, conn) -> None:
        """Adaptive WAL checkpoint pacing (reference db_writing.py:369-394):
        PASSIVE every 2 flushes, forced TRUNCATE at >= 256 MB of WAL.  No-op
        under the unsafe-fast MEMORY-journal profile."""
        if self._unsafe_fast:
            return
        self._flushes_since_passive += 1
        self._flushes_since_truncate += 1
        wal = Path(str(self._db_path) + "-wal")
        try:
            if wal.exists() and wal.stat().st_size >= 256 * 1024 * 1024:
                conn.execute("PRAGMA wal_checkpoint(TRUNCATE)")
                self._flushes_since_passive = 0
                self._flushes_since_truncate = 0
            elif self._flushes_since_passive >= 2:
                conn.execute("PRAGMA wal_checkpoint(PASSIVE)")
                self._flushes_since_passive = 0
        except Exception:  # noqa: BLE001
            # Failure policy: checkpoint pacing is best-effort housekeeping
            logger.debug("wal checkpoint failed", exc_info=True)

    def _idle_maintenance(self, conn) -> None:
        if self._unsafe_fast or self._flushes_since_truncate < 32:
            return
        try:
            conn.execute("PRAGMA wal_checkpoint(TRUNCATE)")
            conn.execute("PRAGMA optimize")
            self._flushes_since_truncate = 0
        except Exception:  # noqa: BLE001
            logger.debug("idle wal maintenance failed", exc_info=True)

    def _flush(self, conn, buffer: list[WriteItem]) -> None:
        if not buffer:
            return
        t0 = time.perf_counter()
        items = [
            TaggingItem(
                file_id=w.file_id, tags=w.tags, width=w.width, height=w.height,
                tagger_sig=w.tagger_sig, tagged_at=w.tagged_at,
            )
            for w in buffer
        ]
        write_tagging_batch(conn, items, tag_cache=self._tag_cache)
        # fused tag+embed batches: vectors persist in the same flush
        by_model: dict[str, list[tuple[int, object]]] = {}
        for w in buffer:
            if w.embedding is not None and w.embed_model:
                by_model.setdefault(w.embed_model, []).append((w.file_id, w.embedding))
        if by_model:
            with conn:
                for model, rows in by_model.items():
                    upsert_embeddings(conn, rows, model=model)
                    self.embeddings_written += len(rows)
        # fused tag+sig batches: duplicate signatures persist in the same flush
        sig_rows = [
            (w.file_id, w.phash, w.dhash) for w in buffer if w.phash is not None
        ]
        if sig_rows:
            with conn:
                upsert_signatures(conn, sig_rows)
            self.signatures_written += len(sig_rows)
        self.items_written += len(buffer)
        self.flushes += 1
        logger.debug("writer flush: %d items in %.3fs", len(buffer), time.perf_counter() - t0)
        buffer.clear()
