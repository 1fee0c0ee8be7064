"""Filesystem safety helpers: system-path guards, trash, hidden checks.

Counterpart of the reference's ``src/utils/fs.py`` (system-path + hidden
checks, Send2Trash wrapper).  Without a desktop trash service the engine
implements trash as an atomic move into a per-data-dir trash folder with a
timestamped name — reversible, never a hard delete.
"""

from __future__ import annotations

import logging
import os
import shutil
import time
from pathlib import Path

logger = logging.getLogger(__name__)

_SYSTEM_PREFIXES = ("/bin", "/boot", "/dev", "/etc", "/lib", "/proc", "/run", "/sbin", "/sys", "/usr")


def is_system_path(path: str | Path) -> bool:
    p = str(Path(path).absolute())
    return any(p == pre or p.startswith(pre + os.sep) for pre in _SYSTEM_PREFIXES)


def is_hidden(path: str | Path) -> bool:
    return any(part.startswith(".") for part in Path(path).parts if part not in ("/", ".."))


def trash_file(path: str | Path, *, trash_dir: str | Path) -> Path | None:
    """Move a file into the trash dir (timestamped to avoid collisions).

    Returns the trashed path, or None when the source is missing. Refuses
    system paths.
    """
    src = Path(path)
    if is_system_path(src):
        raise ValueError(f"refusing to trash system path: {src}")
    if not src.exists():
        return None
    dest_dir = Path(trash_dir)
    dest_dir.mkdir(parents=True, exist_ok=True)
    stamp = time.strftime("%Y%m%d_%H%M%S")
    dest = dest_dir / f"{stamp}_{src.name}"
    counter = 0
    while dest.exists():
        counter += 1
        dest = dest_dir / f"{stamp}_{counter}_{src.name}"
    shutil.move(str(src), str(dest))
    logger.info("trashed %s -> %s", src, dest)
    return dest


def restore_from_trash(trashed: str | Path, original: str | Path) -> Path:
    """Move a trashed file back to its original location."""
    src = Path(trashed)
    dest = Path(original)
    dest.parent.mkdir(parents=True, exist_ok=True)
    shutil.move(str(src), str(dest))
    return dest


# Trash manifest: restore needs the ORIGINAL path, which the timestamped
# trash name does not carry.  One JSONL file per trash dir; every trashing
# caller appends {file_id, original, trashed, ts} so `ket trash` can list
# and undo (the reference delegates this to the OS recycle bin via
# Send2Trash; an app-dir trash must keep its own book).
_MANIFEST = "trash.jsonl"


def _manifest_lock(trash_dir: Path):
    """flock-guarded handle on the manifest's sibling lockfile: appends (any
    trashing surface, incl. a live `ket serve`) and the restore rewrite can
    interleave across processes without losing records."""
    import fcntl
    from contextlib import contextmanager

    @contextmanager
    def _held():
        trash_dir.mkdir(parents=True, exist_ok=True)
        with open(trash_dir / (_MANIFEST + ".lock"), "w") as lock_fh:
            fcntl.flock(lock_fh, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(lock_fh, fcntl.LOCK_UN)

    return _held()


def append_trash_record(
    trash_dir: str | Path, *, file_id: int, original: str | Path, trashed: str | Path
) -> None:
    import json
    import time as _time

    d = Path(trash_dir)
    with _manifest_lock(d):
        with open(d / _MANIFEST, "a", encoding="utf-8") as fh:
            fh.write(json.dumps({
                "file_id": int(file_id), "original": str(original),
                "trashed": str(trashed), "ts": _time.time(),
            }) + "\n")


def _valid_record(rec: object) -> bool:
    return (
        isinstance(rec, dict)
        and isinstance(rec.get("original"), str)
        and isinstance(rec.get("trashed"), str)
        and isinstance(rec.get("file_id"), int)
    )


def load_trash_records(trash_dir: str | Path) -> list[dict]:
    """Manifest rows, oldest first; corrupt or mis-shaped lines are skipped,
    never fatal (a half-written line must not block every restore)."""
    import json

    p = Path(trash_dir) / _MANIFEST
    if not p.exists():
        return []
    out: list[dict] = []
    for line in p.read_text(encoding="utf-8").splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            logger.warning("skipping corrupt trash manifest line: %r", line[:80])
            continue
        if _valid_record(rec):
            out.append(rec)
        else:
            logger.warning("skipping mis-shaped trash manifest line: %r", line[:80])
    return out


def remove_trash_records(trash_dir: str | Path, trashed_paths: set[str]) -> None:
    """Drop the given records (by their trashed path) under the manifest
    lock, RE-READING first — records appended by another process since the
    caller's load survive the rewrite."""
    import json

    d = Path(trash_dir)
    with _manifest_lock(d):
        keep = [
            rec for rec in load_trash_records(d)
            if rec["trashed"] not in trashed_paths
        ]
        p = d / _MANIFEST
        tmp = p.with_suffix(".jsonl.tmp")
        with open(tmp, "w", encoding="utf-8") as fh:
            for rec in keep:
                fh.write(json.dumps(rec) + "\n")
        tmp.replace(p)
