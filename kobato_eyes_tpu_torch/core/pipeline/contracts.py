"""Shared pipeline data contracts (reference ``core/pipeline/contracts.py``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path


@dataclass
class FileRecord:
    """Mutable per-file state threaded through the stages
    (reference types.py _FileRecord)."""

    file_id: int
    path: Path
    size: int
    mtime: float
    width: int | None = None
    height: int | None = None
    needs_tagging: bool = False
    content_changed: bool = False  # new file or bytes changed (sha mismatch)
    touched: bool = False  # size/mtime moved (content may be identical)
    tagged: bool = False
    failed: bool = False
    embedded: bool = False  # ANN vector stored this run (fused tag+embed)
    signed: bool = False  # pHash/dHash stored this run (fused tag+sig)


@dataclass(frozen=True)
class WriteItem:
    """One file's tagging result bound for the catalog (reference DBItem).

    ``embedding`` (the ANN vector) and ``phash``/``dhash`` (the duplicate
    signatures) ride along when the tag stage fused those forwards into the
    same device dispatch (core/pipeline/tag_stage.py): during the quiesce
    window the async writer's EXCLUSIVE connection is the only one allowed
    to touch the catalog, so they travel through the write queue instead of
    a second connection."""

    file_id: int
    tags: list[tuple[str, float, int]]  # (name, score, category)
    width: int | None
    height: int | None
    tagger_sig: str
    tagged_at: float
    embedding: object | None = None  # np.float32 (D,) vector
    embed_model: str | None = None  # embeddings.model key for the vector
    phash: int | None = None  # signed-64 pHash (fused tag+sig)
    dhash: int | None = None  # signed-64 dHash (fused tag+sig)


@dataclass(frozen=True)
class WriteFlush:
    """Queue sentinel: flush buffered items now."""


@dataclass(frozen=True)
class WriteStop:
    """Queue sentinel: flush then stop the writer."""

    flush: bool = True


@dataclass
class ScanResult:
    records: list[FileRecord] = field(default_factory=list)
    new: int = 0
    changed: int = 0
    missing_ids: list[int] = field(default_factory=list)
