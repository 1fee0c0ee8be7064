"""Catalog administration: reset with timestamped backups.

Counterpart of the reference's ``src/db/admin.py:40-82``: resetting never
destroys data — the db (and -wal/-shm journals) are renamed to timestamped
backups first, and the bootstrap cache is invalidated so the next connection
recreates a fresh schema.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path

from kobato_eyes_tpu_torch.db.connection import reset_bootstrap_cache

logger = logging.getLogger(__name__)


def reset_database(db_path: str | Path, *, backup: bool = True) -> list[Path]:
    """Move the database (and journals) aside; returns backup paths."""
    db = Path(db_path)
    stamp = time.strftime("%Y%m%d_%H%M%S")
    backups: list[Path] = []
    for suffix in ("", "-wal", "-shm"):
        src = Path(str(db) + suffix)
        if not src.exists():
            continue
        if backup:
            dest = src.with_name(f"{src.name}.bak_{stamp}")
            src.rename(dest)
            backups.append(dest)
            logger.info("backed up %s -> %s", src, dest)
        else:
            src.unlink()
            logger.info("removed %s", src)
    reset_bootstrap_cache()
    return backups


def list_backups(db_path: str | Path) -> list[Path]:
    db = Path(db_path)
    return sorted(db.parent.glob(f"{db.name}.bak_*"))
