"""Tag stage: prefetch-loaded batches through the device tagger.

Counterpart of ``kobato_eyes_tpu/core/pipeline/tag_stage.py``. Parity
behaviors from the reference (``core/pipeline/stages/tag_stage.py``):

* records sorted by (parent, size) for IO locality (done in the loader);
* **halving retry** — a failed batch is recursively split in two so one
  poison image costs log2(B) retries, not the batch (:200-214);
* duplicate tag names within one result keep the max score (:283-292);
* emits WriteItems to the async writer and flips record state.

Two lanes ride the same decode. The pHash/dHash words of files in
``sig_need``: the loader makes the grayscale hash tiles, this stage queues
the hash pass on ``sig_device`` beside the batch's dispatch, and the words
ride the WriteItems. The ANN vectors of files in ``embed_need``: a batch
that needs them is uploaded ONCE (from pinned memory on the card) and the
same device tensor goes to the embedder and to the tagger; the vectors ride
the WriteItems. A failed fused dispatch or completion downgrades the batch
to tags-only, and the orchestrator's residual embed stage covers it.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Protocol, Sequence

import numpy as np

from kobato_eyes_tpu_torch.core.pipeline.contracts import FileRecord, WriteItem
from kobato_eyes_tpu_torch.core.pipeline.loaders import PreparedBatch, PrefetchLoader
from kobato_eyes_tpu_torch.core.progress import IndexPhase, IndexProgress, ProgressEmitter
from kobato_eyes_tpu_torch.models.base import ITagger, TagResult

logger = logging.getLogger(__name__)


class WriteSink(Protocol):
    def put(self, item: WriteItem, *, timeout: float | None = None) -> None: ...


@dataclass
class TagStageResult:
    tagged: int = 0
    failed: int = 0
    skipped: int = 0
    infer_seconds: float = 0.0
    batches: int = 0
    failed_ids: list[int] = field(default_factory=list)
    signed: int = 0  # pHash/dHash signatures fused into tag dispatches
    embedded: int = 0  # ANN vectors fused into tag dispatches


class TagStage:
    def __init__(
        self,
        tagger: ITagger,
        *,
        tagger_sig: str,
        batch_size: int = 32,
        prefetch_depth: int = 4,
        io_workers: int = 8,
        input_cache_dir: str | None = None,
        is_cancelled: Callable[[], bool] | None = None,
        pipeline_depth: int = 3,
        embedder=None,  # index.embedder.ImageEmbedder in derived-prep mode
        embed_need: set[int] | None = None,
        sig_need: set[int] | None = None,
        sig_device=None,
    ) -> None:
        self._tagger = tagger
        self._tagger_sig = tagger_sig
        self._batch_size = batch_size
        self._prefetch_depth = prefetch_depth
        self._io_workers = io_workers
        self._input_cache_dir = input_cache_dir
        self._is_cancelled = is_cancelled or (lambda: False)
        self._pipeline_depth = max(1, int(pipeline_depth))
        self._embedder = embedder
        self._embed_need = embed_need or set()
        # Fused signatures (tag+sig): files whose pHash/dHash should be
        # computed from the tag stage's decode — the loader produces the
        # grayscale hash tiles, this stage chains the hash pass onto the
        # batch dispatch, and the words ride the WriteItems. Any failure is
        # a downgrade: the standalone compute_signatures lane (ket dup)
        # covers whatever has no signature row.
        self._sig_need = sig_need or set()
        self._sig_device = sig_device

    def run(
        self,
        records: Sequence[FileRecord],
        sink: WriteSink,
        progress: ProgressEmitter,
    ) -> TagStageResult:
        todo = [r for r in records if r.needs_tagging]
        result = TagStageResult(skipped=len(records) - len(todo))
        if not todo:
            return result
        progress.phase(IndexPhase.TAG, 0, len(todo))
        from kobato_eyes_tpu_torch.core.pipeline.loaders import PreparedInputCache

        cache = (
            PreparedInputCache(
                self._input_cache_dir,
                namespace=f"{getattr(self._tagger, 'mode', 'tagger')}:{self._tagger.input_size}",
            )
            if self._input_cache_dir
            else None
        )
        loader = PrefetchLoader(
            todo,
            prepare=self._tagger.prepare_batch_from_rgb,
            batch_size=self._batch_size,
            prefetch_depth=self._prefetch_depth,
            io_workers=self._io_workers,
            cache=cache,
            is_cancelled=self._is_cancelled,
            sig_need=self._sig_need,
        )
        # Bounded in-flight pipeline: up to pipeline_depth batches are
        # dispatched before the oldest is fetched, so host decode and the
        # per-batch fetch overlap device compute. Taggers without the
        # dispatch/complete split (dummy, test fakes) take the per-batch
        # path. Failure policy: a batch whose dispatch OR completion raises
        # re-runs through the synchronous halving retry.
        can_pipeline = (
            self._pipeline_depth > 1
            and hasattr(self._tagger, "dispatch_batch_prepared")
            and hasattr(self._tagger, "complete_batch_prepared")
        )
        # Fused embedding: when the embedder's derived prep IS the tagger's
        # prepared geometry, the batch is uploaded once and BOTH forwards
        # read the same device pixels: no second decode, no second upload.
        spec = getattr(self._tagger, "spec", None)
        can_fuse = (
            can_pipeline
            and self._embedder is not None
            and bool(self._embed_need)
            and spec is not None
            and self._embedder.accepts_prepared(self._tagger.input_size, spec.mode)
        )
        inflight: deque = deque()
        done = 0
        for batch in loader:
            if self._is_cancelled():
                break
            if not can_pipeline:
                self._infer_with_retry(batch, sink, result)
                done += len(batch.records)
                progress.emit(IndexProgress(IndexPhase.TAG, done, len(todo)))
                continue
            t0 = time.perf_counter()
            pixels = batch.pixels
            emb_pending = None
            if can_fuse and any(r.file_id in self._embed_need for r in batch.records):
                try:
                    pixels = self._upload(batch.pixels)
                    emb_pending = self._embedder.dispatch_batch_prepared(pixels)
                except Exception:  # noqa: BLE001 — the residual embed stage covers
                    logger.warning(
                        "fused embed dispatch failed; batch downgraded to tags-only",
                        exc_info=True,
                    )
                    pixels, emb_pending = batch.pixels, None
            try:
                handle = self._tagger.dispatch_batch_prepared(pixels)
            except Exception:  # noqa: BLE001 — shape/launch errors
                logger.warning("dispatch failed; falling back to sync retry", exc_info=True)
                self._infer_with_retry(batch, sink, result)
                done += len(batch.records)
                progress.emit(IndexProgress(IndexPhase.TAG, done, len(todo)))
                continue
            result.infer_seconds += time.perf_counter() - t0
            sig_pending = self._sig_dispatch(batch)
            inflight.append((batch, handle, emb_pending, sig_pending))
            if len(inflight) >= self._pipeline_depth:
                done += self._complete_pipelined(*inflight.popleft(), sink=sink, result=result)
                progress.emit(IndexProgress(IndexPhase.TAG, done, len(todo)))
        while inflight and not self._is_cancelled():
            done += self._complete_pipelined(*inflight.popleft(), sink=sink, result=result)
            progress.emit(IndexProgress(IndexPhase.TAG, done, len(todo)))
        # decode failures discovered by the loader
        for r in todo:
            if r.failed and r.file_id not in result.failed_ids:
                result.failed += 1
                result.failed_ids.append(r.file_id)
        logger.info(
            "tag: %d tagged, %d failed, %d skipped, infer=%.2fs over %d batches",
            result.tagged, result.failed, result.skipped,
            result.infer_seconds, result.batches,
        )
        return result

    def _upload(self, pixels: np.ndarray):
        """The batch on the embedder's device, copied once: from pinned host
        memory without blocking on the card, as it is on the CPU."""
        import torch

        host = torch.from_numpy(np.ascontiguousarray(pixels))
        device = self._embedder.device
        if device.type == "cuda":
            return host.pin_memory().to(device, non_blocking=True)
        return host.to(device)

    def _sig_dispatch(self, batch: PreparedBatch):
        """Queue the pHash/dHash pass for the batch's hash tiles (fused
        tag+sig) WITHOUT syncing; returns (indices, pending) or None."""
        idxs = [i for i, g in enumerate(batch.grays) if g is not None]
        if not idxs:
            return None
        try:
            from kobato_eyes_tpu_torch.sig.signatures import dispatch_hash_batch

            g32 = np.stack([batch.grays[i][0] for i in idxs])
            g98 = np.stack([batch.grays[i][1] for i in idxs])
            return idxs, dispatch_hash_batch(g32, g98, device=self._sig_device)
        except Exception:  # noqa: BLE001 — standalone signature lane covers
            logger.warning("fused sig dispatch failed; batch downgraded", exc_info=True)
            return None

    def _sig_complete(self, pending) -> dict[int, tuple[int, int]]:
        """Fetch a dispatched hash pair -> {batch index: (phash, dhash)}."""
        if pending is None:
            return {}
        idxs, handles = pending
        try:
            from kobato_eyes_tpu_torch.sig.signatures import complete_hash_batch

            ph, dh = complete_hash_batch(handles)
            return {i: (p, d) for i, p, d in zip(idxs, ph, dh)}
        except Exception:  # noqa: BLE001 — standalone signature lane covers
            logger.warning("fused sig completion failed; batch downgraded", exc_info=True)
            return {}

    def _complete_pipelined(
        self, batch: PreparedBatch, handle: tuple, emb_pending=None,
        sig_pending=None, *, sink: WriteSink, result: TagStageResult,
    ) -> int:
        """Fetch one in-flight batch; device failures re-run it through the
        synchronous halving retry (same terminal behavior as the sync path)."""
        try:
            t0 = time.perf_counter()
            outputs = self._tagger.complete_batch_prepared(handle)
            result.infer_seconds += time.perf_counter() - t0
            result.batches += 1
        except Exception:  # noqa: BLE001
            logger.warning(
                "pipelined batch of %d failed at completion; sync retry",
                len(batch.records), exc_info=True,
            )
            self._infer_with_retry(batch, sink, result)
            return len(batch.records)
        vecs = model_key = None
        if emb_pending is not None:
            try:
                t0 = time.perf_counter()
                vecs = self._embedder.complete_batch_prepared(emb_pending)
                result.infer_seconds += time.perf_counter() - t0
                model_key = self._embedder.model_key
            except Exception:  # noqa: BLE001 — the residual embed stage covers
                logger.warning(
                    "fused embed completion failed; batch downgraded to tags-only",
                    exc_info=True,
                )
                vecs = None
        sigs = self._sig_complete(sig_pending)
        now = time.time()
        for i, (record, output) in enumerate(zip(batch.records, outputs)):
            emb = None
            if vecs is not None and record.file_id in self._embed_need:
                emb = np.asarray(vecs[i], np.float32)
                record.embedded = True
                result.embedded += 1
            sig = sigs.get(i)
            if sig is not None:
                record.signed = True
                result.signed += 1
            sink.put(self._to_write_item(
                record, output, now, embedding=emb, embed_model=model_key, sig=sig,
            ))
            record.tagged = True
            result.tagged += 1
        return len(batch.records)

    def _infer_with_retry(
        self, batch: PreparedBatch, sink: WriteSink, result: TagStageResult
    ) -> None:
        """Run one prepared batch; on failure split in half recursively
        (reference halving retry)."""
        try:
            t0 = time.perf_counter()
            outputs = self._tagger.infer_batch_prepared(batch.pixels)
            result.infer_seconds += time.perf_counter() - t0
            result.batches += 1
        except Exception:  # noqa: BLE001
            n = len(batch.records)
            if n <= 1:
                logger.exception("inference failed for %s; skipping", batch.records[0].path)
                batch.records[0].failed = True
                result.failed += 1
                result.failed_ids.append(batch.records[0].file_id)
                return
            mid = n // 2
            logger.warning("batch of %d failed; retrying as %d + %d", n, mid, n - mid)
            for lo, hi in ((0, mid), (mid, n)):
                sub = PreparedBatch(
                    records=batch.records[lo:hi],
                    pixels=batch.pixels[lo:hi],
                    sizes=batch.sizes[lo:hi],
                    grays=batch.grays[lo:hi] if batch.grays else [],
                )
                self._infer_with_retry(sub, sink, result)
            return

        # fused sigs on the sync path: dispatch + complete back-to-back
        sigs = self._sig_complete(self._sig_dispatch(batch))
        now = time.time()
        for i, (record, output) in enumerate(zip(batch.records, outputs)):
            sig = sigs.get(i)
            if sig is not None:
                record.signed = True
                result.signed += 1
            sink.put(self._to_write_item(record, output, now, sig=sig))
            record.tagged = True
            result.tagged += 1

    def _to_write_item(
        self, record: FileRecord, output: TagResult, now: float,
        embedding: np.ndarray | None = None, embed_model: str | None = None,
        sig: tuple[int, int] | None = None,
    ) -> WriteItem:
        # Duplicate names keep the max score (reference tag_stage.py:283-292).
        merged: dict[str, tuple[float, int]] = {}
        for t in output.tags:
            prev = merged.get(t.name)
            if prev is None or t.score > prev[0]:
                merged[t.name] = (float(t.score), int(t.category))
        return WriteItem(
            file_id=record.file_id,
            tags=[(name, score, cat) for name, (score, cat) in merged.items()],
            width=record.width,
            height=record.height,
            tagger_sig=self._tagger_sig,
            tagged_at=now,
            embedding=embedding,
            embed_model=embed_model if embedding is not None else None,
            phash=sig[0] if sig is not None else None,
            dhash=sig[1] if sig is not None else None,
        )
