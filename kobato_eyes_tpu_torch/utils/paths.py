"""Application data-directory layout.

Counterpart of the reference's ``src/core/config/paths.py`` (platformdirs
AppData layout with a ``KOE_DATA_DIR`` override).  This engine is
Linux/server-first: default root is ``~/.local/share/kobato-eyes-tpu`` with a
``KET_DATA_DIR`` override, and the same sub-directory contract (db / index /
cache / logs / snapshots).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path


@dataclass(frozen=True)
class AppPaths:
    root: Path

    @property
    def db_path(self) -> Path:
        return self.root / "db" / "catalog.sqlite3"

    @property
    def index_dir(self) -> Path:
        return self.root / "index"

    @property
    def cache_dir(self) -> Path:
        return self.root / "cache"

    @property
    def log_dir(self) -> Path:
        return self.root / "logs"

    @property
    def snapshot_dir(self) -> Path:
        return self.root / "snapshots"

    def ensure(self) -> "AppPaths":
        for d in (self.db_path.parent, self.index_dir, self.cache_dir, self.log_dir, self.snapshot_dir):
            d.mkdir(parents=True, exist_ok=True)
        return self


def default_root() -> Path:
    override = os.environ.get("KET_DATA_DIR")
    if override:
        return Path(override).expanduser()
    xdg = os.environ.get("XDG_DATA_HOME")
    base = Path(xdg).expanduser() if xdg else Path.home() / ".local" / "share"
    return base / "kobato-eyes-tpu"


def get_app_paths(root: str | Path | None = None) -> AppPaths:
    return AppPaths(root=Path(root) if root is not None else default_root())
