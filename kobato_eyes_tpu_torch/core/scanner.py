"""Filesystem scanner: enumerate candidate images under configured roots.

Semantics parity with the reference (``src/core/scanner.py:8-101``):
allowed-extension filter, excluded-subtree pruning, dot-hidden directory and
file skipping, deterministic ordering.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Sequence

from kobato_eyes_tpu_torch.core.config.schema import DEFAULT_ALLOW_EXTS

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class ScannedFile:
    path: Path
    size: int
    mtime: float


def _is_hidden(name: str) -> bool:
    return name.startswith(".")


def _is_excluded(path: Path, excluded: Sequence[Path]) -> bool:
    for ex in excluded:
        try:
            path.relative_to(ex)
            return True
        except ValueError:
            continue
    return False


def iter_images(
    roots: Sequence[str | Path],
    *,
    excluded: Sequence[str | Path] = (),
    allow_exts: Sequence[str] | None = None,
) -> Iterator[ScannedFile]:
    """Yield image files under ``roots`` (sorted walk, exclusions pruned)."""
    exts = {e.lower() for e in (allow_exts or DEFAULT_ALLOW_EXTS)}
    excluded_paths = [Path(e).absolute() for e in excluded]
    seen: set[Path] = set()
    for root in roots:
        root_path = Path(root).absolute()
        if not root_path.is_dir():
            logger.warning("scan root missing, skipping: %s", root_path)
            continue
        for dirpath, dirnames, filenames in os.walk(root_path):
            here = Path(dirpath)
            dirnames[:] = sorted(
                d for d in dirnames
                if not _is_hidden(d) and not _is_excluded((here / d).absolute(), excluded_paths)
            )
            for name in sorted(filenames):
                if _is_hidden(name):
                    continue
                p = here / name
                if p.suffix.lower() not in exts:
                    continue
                ap = p.absolute()
                if ap in seen:
                    continue
                seen.add(ap)
                try:
                    st = ap.stat()
                except OSError as exc:
                    # Failure policy: unreadable entries are per-item skips.
                    logger.warning("stat failed for %s: %s", ap, exc)
                    continue
                yield ScannedFile(path=ap, size=st.st_size, mtime=st.st_mtime)
