"""Copy search results into a per-query export folder.

Counterpart of the reference's "Copy results…" action
(``src/ui/tags_db.py:36-126`` + ``src/utils/search_export.py:10-41`` +
``src/ui/tags_workers.py:112-124``): the full hit set of the current query
is copied into a timestamped folder named after the query, name collisions
resolve with ``_2``/``_3``… suffixes, ``copy2`` preserves metadata, and a
missing or unreadable source counts as a failure instead of aborting the
batch.  Headless here: the CLI drives it (``ket search --copy[-to]``) and
reports ``(copied, failed, dest)`` instead of a dialog.
"""

from __future__ import annotations

import itertools
import re
import shutil
import time
from pathlib import Path
from typing import Callable, Iterable

__all__ = [
    "sanitize_for_folder",
    "make_export_dir",
    "unique_destination",
    "copy_results",
]


def sanitize_for_folder(name: str, max_len: int = 60) -> str:
    """Keep only folder-name-safe characters; ``'query'`` when empty.

    Same normalization as the reference (``utils/search_export.py:21-29``):
    path separators and reserved punctuation collapse to ``_``, runs of
    whitespace become a single ``_``, and the result is length-capped.
    """
    s = re.sub(r"[\\/:*?\"<>|]+", "_", name)
    s = re.sub(r"\s+", " ", s).strip().replace(" ", "_")
    if not s:
        s = "query"
    return s[:max_len]


def make_export_dir(query: str, root: Path) -> Path:
    """Create and return ``root/<YYYYmmdd-HHMMSS>-<sanitized query>``.

    ``root`` is the caller's search-results root (the CLI uses
    ``<data-dir>/cache/search_results``, the analog of the reference's
    AppData ``search_results`` root).
    """
    ts = time.strftime("%Y%m%d-%H%M%S")
    dest = Path(root) / f"{ts}-{sanitize_for_folder(query)}"
    dest.mkdir(parents=True, exist_ok=True)
    return dest


def unique_destination(dest_dir: Path, filename: str) -> Path:
    """Non-conflicting destination path inside ``dest_dir`` (``_2``, ``_3``…)."""
    dest = dest_dir / filename
    if not dest.exists():
        return dest
    stem, suffix = dest.stem, dest.suffix
    for index in itertools.count(2):
        candidate = dest_dir / f"{stem}_{index}{suffix}"
        if not candidate.exists():
            return candidate
    raise AssertionError("unreachable")


def copy_results(
    paths: Iterable[str | Path],
    dest_dir: Path,
    *,
    is_cancelled: Callable[[], bool] | None = None,
    on_progress: Callable[[int, int], None] | None = None,
) -> tuple[int, int]:
    """Copy every source file into ``dest_dir``; returns ``(ok, failed)``.

    A missing source or a per-file copy error increments ``failed`` and the
    batch continues (reference ``tags_db.py:76-89``).  ``on_progress(done,
    total)`` fires after each file; ``is_cancelled()`` stops between files.
    """
    items = [Path(p) for p in paths]
    total = len(items)
    ok = failed = 0
    dest_dir = Path(dest_dir)
    dest_dir.mkdir(parents=True, exist_ok=True)
    for idx, src in enumerate(items, start=1):
        if is_cancelled is not None and is_cancelled():
            break
        try:
            if src.exists():
                shutil.copy2(src, unique_destination(dest_dir, src.name))
                ok += 1
            else:
                failed += 1
        except OSError:
            failed += 1
        if on_progress is not None:
            on_progress(idx, total)
    return ok, failed
