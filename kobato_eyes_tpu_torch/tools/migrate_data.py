"""Migrate persisted data into the current application data layout.

Counterpart of the reference's ``tools/migrate_data_paths.py`` (which moves a
legacy repo-root SQLite file and a legacy AppData directory into the unified
platformdirs layout).  This engine's layout is ``AppPaths`` under
``~/.local/share/kobato-eyes-tpu`` (``KET_DATA_DIR`` override) with ``db/``,
``index/``, ``cache/``, ``logs/``, ``snapshots/`` sub-directories
(``kobato_eyes_tpu_torch/utils/paths.py``).

Two migrations are supported, both idempotent and refusing to overwrite:

1. **Flat legacy root** — early layouts kept ``catalog.sqlite3`` (and its
   ``-wal``/``-shm`` side files) directly in the data root; they move into
   ``<root>/db/``.
2. **Legacy home directory** — a pre-XDG ``~/.kobato-eyes-tpu`` directory is
   relocated wholesale to the current root when the current root has no data
   yet.
"""

from __future__ import annotations

import shutil
from pathlib import Path

from kobato_eyes_tpu_torch.utils.paths import AppPaths, get_app_paths

_DB_BASENAME = "catalog.sqlite3"
_DB_SUFFIXES = ("", "-wal", "-shm")


def legacy_home_dir() -> Path:
    return Path.home() / ".kobato-eyes-tpu"


def migrate_flat_db(paths: AppPaths) -> bool:
    """Move a data-root-level catalog DB into the ``db/`` sub-directory."""
    flat_db = paths.root / _DB_BASENAME
    if not flat_db.exists():
        return False
    if paths.db_path.exists():
        return False
    paths.db_path.parent.mkdir(parents=True, exist_ok=True)
    for suffix in _DB_SUFFIXES:
        source = paths.root / f"{_DB_BASENAME}{suffix}"
        if source.exists():
            shutil.move(str(source), str(paths.db_path.parent / source.name))
    return True


def migrate_legacy_home(paths: AppPaths, legacy: Path | None = None) -> bool:
    """Relocate a pre-XDG ``~/.kobato-eyes-tpu`` directory to the current root."""
    legacy = legacy if legacy is not None else legacy_home_dir()
    if not legacy.is_dir() or legacy == paths.root:
        return False
    # Refuse if the current root already holds data (a bare directory
    # skeleton with no DB does not count).
    if paths.db_path.exists() or (paths.root / _DB_BASENAME).exists():
        return False
    paths.root.parent.mkdir(parents=True, exist_ok=True)
    if paths.root.exists():
        # Merge: move children that do not collide, leave the rest in place.
        moved_any = False
        for child in legacy.iterdir():
            target = paths.root / child.name
            if not target.exists():
                shutil.move(str(child), str(target))
                moved_any = True
        return moved_any
    shutil.move(str(legacy), str(paths.root))
    return True


def migrate_all(paths: AppPaths | None = None) -> bool:
    paths = paths if paths is not None else get_app_paths()
    moved_home = migrate_legacy_home(paths)
    moved_flat = migrate_flat_db(paths)
    return moved_home or moved_flat


def main() -> None:
    paths = get_app_paths()
    if migrate_all(paths):
        print(f"Migration completed. Data directory is {paths.root}")
    else:
        print(f"No migration required. Data directory is {paths.root}")


if __name__ == "__main__":
    main()
