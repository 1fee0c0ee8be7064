"""Prefetching input pipeline: decode on host threads, batches ready for device.

TPU-first analog of the reference's producer-thread loader
(``src/core/pipeline/loaders.py:229-536``): a producer thread fans decode out
to a thread pool and pushes *prepared* fixed-shape uint8 batches into a
bounded queue, overlapping host IO/decode with device inference.  Producer
exceptions are captured and re-raised at the consumer (failure policy of
loaders.py:514-536); per-item decode failures are skips, never fatal.

Batch sorting by (parent dir, size) for IO locality mirrors
``tag_stage.py:105-111``.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Iterator, Sequence

import numpy as np

from kobato_eyes_tpu_torch.core.pipeline.contracts import FileRecord
from kobato_eyes_tpu_torch.utils.image_io import load_rgb_array

logger = logging.getLogger(__name__)


@dataclass
class LoaderMetrics:
    """Input-pipeline observability (reference LoaderMetrics, loaders.py:44-85)."""

    decoded: int = 0
    failed: int = 0
    decode_seconds: float = 0.0
    queue_wait_seconds: float = 0.0
    batches: int = 0
    slowest: list[tuple[float, str]] = field(default_factory=list)  # (seconds, path) top-N

    def note_decode(self, seconds: float, path: str) -> None:
        self.decoded += 1
        self.decode_seconds += seconds
        self.slowest.append((seconds, path))
        self.slowest.sort(reverse=True)
        del self.slowest[20:]

    def summary(self) -> str:
        return (
            f"decoded={self.decoded} failed={self.failed} batches={self.batches} "
            f"decode_s={self.decode_seconds:.2f} queue_wait_s={self.queue_wait_seconds:.2f}"
        )


@dataclass
class PreparedBatch:
    records: list[FileRecord]
    pixels: np.ndarray  # (B, S, S, 3) uint8
    sizes: list[tuple[int, int]]  # original (width, height) per record
    # per-record (g32, g98) grayscale hash tiles, None where not computed
    # (record not in sig_need, or served from the prepared-input cache which
    # stores post-letterbox pixels only) — fused tag+sig lane
    grays: list[tuple[np.ndarray, np.ndarray] | None] = field(default_factory=list)


_SENTINEL = object()

# bump when the prepared-tensor layout changes (cache invalidation)
_CACHE_VERSION = "v1"


class PreparedInputCache:
    """Per-file prepared-tensor cache keyed by path+size+mtime+version.

    Counterpart of the reference's ``.npz`` input cache
    (``loaders.py:310-380``): skips decode+resize for unchanged files on
    re-tag runs (model changes re-tag the whole library; pixels don't change).
    """

    def __init__(self, cache_dir: str | Path, *, namespace: str = "") -> None:
        # namespace MUST identify the preprocess convention (mode + target
        # size): tensors prepared for one tagger are wrong for another.
        self.dir = Path(cache_dir)
        self.namespace = namespace
        self.hits = 0
        self.misses = 0

    def _key(self, record: FileRecord) -> Path:
        import hashlib

        raw = f"{record.path}|{record.size}|{record.mtime}|{self.namespace}|{_CACHE_VERSION}"
        digest = hashlib.sha1(raw.encode()).hexdigest()
        return self.dir / digest[:2] / f"{digest}.npz"

    def get(self, record: FileRecord) -> tuple[np.ndarray, int, int] | None:
        path = self._key(record)
        if not path.exists():
            self.misses += 1
            return None
        try:
            data = np.load(path)
            self.hits += 1
            return data["pixels"], int(data["w"]), int(data["h"])
        except (OSError, ValueError, KeyError):
            self.misses += 1
            return None

    def put(self, record: FileRecord, pixels: np.ndarray, w: int, h: int) -> None:
        path = self._key(record)
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(".tmp.npz")
            np.savez(tmp, pixels=pixels, w=w, h=h)
            tmp.replace(path)
        except OSError as exc:
            # Failure policy: cache writes are best-effort.
            logger.debug("input cache write failed for %s: %s", record.path, exc)


class PrefetchLoader:
    """Iterate prepared batches with bounded prefetch."""

    def __init__(
        self,
        records: Sequence[FileRecord],
        *,
        prepare: Callable[[list[np.ndarray]], np.ndarray],
        batch_size: int = 32,
        prefetch_depth: int = 4,
        io_workers: int = 8,
        cache: PreparedInputCache | None = None,
        is_cancelled: Callable[[], bool] | None = None,
        sig_need: set[int] | None = None,
    ) -> None:
        # (parent dir, size) ordering for IO locality.
        self._records = sorted(records, key=lambda r: (str(r.path.parent), r.size))
        self._prepare = prepare
        self._batch_size = batch_size
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, prefetch_depth))
        self._io_workers = io_workers
        self._cache = cache
        self._is_cancelled = is_cancelled or (lambda: False)
        # files whose duplicate signatures should be computed from the same
        # decode (fused tag+sig): only possible on a fresh decode — cache
        # hits carry prepared pixels, not the original-geometry image
        self._sig_need = sig_need or set()
        self._error: BaseException | None = None
        self._abandoned = threading.Event()
        self.metrics = LoaderMetrics()
        self._thread = threading.Thread(target=self._producer, name="prefetch-loader", daemon=True)

    def _prepare_one(
        self, record: FileRecord
    ) -> tuple[FileRecord, np.ndarray | None, tuple[np.ndarray, np.ndarray] | None]:
        """Decode + single-image prepare (cache-aware): -> (S, S, 3) uint8,
        plus the (g32, g98) hash tiles when the record needs signatures and
        the image was freshly decoded."""
        if self._cache is not None:
            hit = self._cache.get(record)
            if hit is not None:
                pixels, w, h = hit
                record.width, record.height = w, h
                return record, pixels, None
        t0 = time.perf_counter()
        arr = load_rgb_array(record.path)
        if arr is None:
            self.metrics.failed += 1
            record.failed = True
            return record, None, None
        self.metrics.note_decode(time.perf_counter() - t0, str(record.path))
        record.width, record.height = arr.shape[1], arr.shape[0]
        grays = None
        if record.file_id in self._sig_need:
            from kobato_eyes_tpu_torch.sig.signatures import gray_pair_from_rgb

            try:
                grays = gray_pair_from_rgb(arr)
            except Exception:  # noqa: BLE001 — best-effort; standalone lane covers
                logger.warning("hash-tile prep failed for %s", record.path, exc_info=True)
        pixels = self._prepare([arr])[0]
        if self._cache is not None:
            self._cache.put(record, pixels, record.width, record.height)
        return record, pixels, grays

    def _producer(self) -> None:
        try:
            with ThreadPoolExecutor(max_workers=self._io_workers) as pool:
                for start in range(0, len(self._records), self._batch_size):
                    if self._is_cancelled():
                        break
                    chunk = self._records[start : start + self._batch_size]
                    decoded = list(pool.map(self._prepare_one, chunk))
                    ok = [(r, a, g) for r, a, g in decoded if a is not None]
                    if not ok:
                        continue
                    pixels = np.stack([a for _, a, _ in ok])
                    batch = PreparedBatch(
                        records=[r for r, _, _ in ok],
                        pixels=pixels,
                        sizes=[(r.width or 0, r.height or 0) for r, _, _ in ok],
                        grays=[g for _, _, g in ok],
                    )
                    t0 = time.perf_counter()
                    # bounded put in slices: an abandoned consumer (exception
                    # in the processing loop) must not strand this thread
                    while True:
                        if self._abandoned.is_set() or self._is_cancelled():
                            return
                        try:
                            self._queue.put(batch, timeout=0.25)
                            break
                        except queue.Full:
                            continue
                    self.metrics.queue_wait_seconds += time.perf_counter() - t0
                    self.metrics.batches += 1
        except BaseException as exc:  # noqa: BLE001
            # Failure policy: producer errors must propagate to the consumer.
            self._error = exc
        finally:
            # never block on the sentinel: if the consumer is gone the queue
            # may be full and will simply never be read again
            while True:
                try:
                    self._queue.put(_SENTINEL, timeout=0.25)
                    break
                except queue.Full:
                    if self._abandoned.is_set():
                        break

    def __iter__(self) -> Iterator[PreparedBatch]:
        self._thread.start()
        try:
            while True:
                item = self._queue.get()
                if item is _SENTINEL:
                    break
                yield item
        finally:
            # consumer done or abandoned (exception mid-loop): release the
            # producer, drain anything it already queued, and reap the thread
            self._abandoned.set()
            while True:
                try:
                    self._queue.get_nowait()
                except queue.Empty:
                    break
            self._thread.join(timeout=30)
        if self._error is not None:
            raise self._error
        logger.info("loader: %s", self.metrics.summary())
