"""Catalog CRUD + SQL search fallback.

Function-level parity with the reference repository (``src/db/repository.py``):
COALESCE-style file upsert, batch tagging writes, signature upserts, dup-scan
row iteration, soft delete, threshold table access, and a ``search_files``
that preserves the relevance-CTE semantics (:295-408) — used as the
executable spec the device query engine is tested against, and as the
fallback path when no device epoch is resident.
"""

from __future__ import annotations

import sqlite3
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Iterator, Mapping, Sequence

from kobato_eyes_tpu_torch.models.base import TagCategory

_CHUNK = 900  # SQLite parameter-count safety (reference uses 900-id chunks)

# Defaults when no per-DB override exists (reference core/query.py:299-304,
# db/common.py:14-18).  Canonical home: every search backend — this SQL spec,
# the device engine, and the CLI — must interpret a thresholds mapping through
# normalize_thresholds so partial tables never degrade to 0.0 gates.
FALLBACK_THRESHOLDS: dict[int, float] = {
    int(TagCategory.GENERAL): 0.35,
    int(TagCategory.CHARACTER): 0.25,
    int(TagCategory.COPYRIGHT): 0.25,
    -1: 0.0,
}


def normalize_thresholds(thresholds: Mapping[int, float] | None) -> dict[int, float]:
    """Overlay user thresholds on the fallbacks (reference _resolve_relevance_thresholds)."""
    merged = dict(FALLBACK_THRESHOLDS)
    for key, value in (thresholds or {}).items():
        try:
            merged[int(key)] = float(value)
        except (TypeError, ValueError):
            continue
    return merged


def _chunks(seq: Sequence, n: int = _CHUNK) -> Iterator[Sequence]:
    for i in range(0, len(seq), n):
        yield seq[i : i + n]


def path_prefix_clause(root: str | Path) -> tuple[str, str]:
    """Separator-anchored, wildcard-escaped LIKE clause for 'under this root'.

    A naive ``root + '%'`` matches sibling directories sharing the root as a
    string prefix (/data/cat matching /data/cats/...) and treats %/_ in the
    root as wildcards — under a hard-delete flow that destroys data.  Returns
    (sql_fragment, pattern) where the fragment is ``path LIKE ? ESCAPE '\\'``.
    """
    base = str(Path(root).absolute()).rstrip("/\\")
    escaped = base.replace("\\", "\\\\").replace("%", "\\%").replace("_", "\\_")
    return "path LIKE ? ESCAPE '\\'", escaped + "/%"


# ---------------------------------------------------------------------------
# files
# ---------------------------------------------------------------------------


def upsert_file(
    conn: sqlite3.Connection,
    *,
    path: str | Path,
    size: int | None = None,
    mtime: float | None = None,
    sha256: str | None = None,
    width: int | None = None,
    height: int | None = None,
    tagger_sig: str | None = None,
    last_tagged_at: float | None = None,
) -> int:
    """Insert or update one file row; unspecified fields keep their values
    (reference repository.py:32-102 COALESCE semantics). Returns the id."""
    now = time.time()
    row = conn.execute(
        """
        INSERT INTO files (path, size, mtime, sha256, width, height, tagger_sig,
                           last_tagged_at, is_present, created_at, updated_at)
        VALUES (?, ?, ?, ?, ?, ?, ?, ?, 1, ?, ?)
        ON CONFLICT(path) DO UPDATE SET
            size = COALESCE(excluded.size, files.size),
            mtime = COALESCE(excluded.mtime, files.mtime),
            sha256 = COALESCE(excluded.sha256, files.sha256),
            width = COALESCE(excluded.width, files.width),
            height = COALESCE(excluded.height, files.height),
            tagger_sig = COALESCE(excluded.tagger_sig, files.tagger_sig),
            last_tagged_at = COALESCE(excluded.last_tagged_at, files.last_tagged_at),
            is_present = 1,
            updated_at = excluded.updated_at
        RETURNING id
        """,
        (str(path), size, mtime, sha256, width, height, tagger_sig, last_tagged_at, now, now),
    ).fetchone()
    return int(row[0])


def bulk_scan_upsert(
    conn: sqlite3.Connection,
    rows: Sequence[tuple[str, int, float, str | None]],
) -> dict[str, int]:
    """Bulk insert-or-update of scan metadata (path, size, mtime, sha256).

    The scan-stage fast path (reference db/files.py bulk_upsert_files_meta):
    one executemany instead of a per-file round trip; sha256=None keeps the
    stored value (COALESCE). Returns path -> id for every row.
    """
    if not rows:
        return {}
    now = time.time()
    conn.executemany(
        """
        INSERT INTO files (path, size, mtime, sha256, is_present, created_at, updated_at)
        VALUES (?, ?, ?, ?, 1, ?, ?)
        ON CONFLICT(path) DO UPDATE SET
            size = excluded.size,
            mtime = excluded.mtime,
            sha256 = COALESCE(excluded.sha256, files.sha256),
            is_present = 1,
            updated_at = excluded.updated_at
        """,
        [(path, size, mtime, sha, now, now) for (path, size, mtime, sha) in rows],
    )
    out: dict[str, int] = {}
    paths = [r[0] for r in rows]
    for chunk in _chunks(paths):
        ph = ",".join("?" * len(chunk))
        for row in conn.execute(
            f"SELECT id, path FROM files WHERE path IN ({ph})", list(chunk)
        ):
            out[row["path"]] = int(row["id"])
    return out


def fetch_files_by_paths(
    conn: sqlite3.Connection, paths: Sequence[str]
) -> dict[str, sqlite3.Row]:
    """Bulk fetch rows (with a has-tags flag) keyed by path, chunked
    (reference scan_stage.py:130-148)."""
    out: dict[str, sqlite3.Row] = {}
    for chunk in _chunks(list(paths)):
        ph = ",".join("?" * len(chunk))
        rows = conn.execute(
            f"""
            SELECT f.*, EXISTS(
                SELECT 1 FROM file_tags ft WHERE ft.file_id = f.id
            ) AS has_tags
            FROM files f WHERE f.path IN ({ph})
            """,
            list(chunk),
        ).fetchall()
        for row in rows:
            out[row["path"]] = row
    return out


def get_file_by_path(conn: sqlite3.Connection, path: str | Path) -> sqlite3.Row | None:
    return conn.execute("SELECT * FROM files WHERE path = ?", (str(path),)).fetchone()


def get_file_by_id(conn: sqlite3.Connection, file_id: int) -> sqlite3.Row | None:
    return conn.execute("SELECT * FROM files WHERE id = ?", (int(file_id),)).fetchone()


def mark_files_absent(conn: sqlite3.Connection, file_ids: Sequence[int]) -> int:
    """Soft delete (reference repository.py:578-591)."""
    n = 0
    for chunk in _chunks(list(file_ids)):
        ph = ",".join("?" * len(chunk))
        cur = conn.execute(
            f"UPDATE files SET is_present = 0, updated_at = ? WHERE id IN ({ph})",
            [time.time(), *chunk],
        )
        n += cur.rowcount
    return n


def mark_files_present(conn: sqlite3.Connection, file_ids: Sequence[int]) -> int:
    """Undo a soft delete (trash restore): dependent rows were never removed."""
    n = 0
    for chunk in _chunks(list(file_ids)):
        ph = ",".join("?" * len(chunk))
        cur = conn.execute(
            f"UPDATE files SET is_present = 1, updated_at = ? WHERE id IN ({ph})",
            [time.time(), *chunk],
        )
        n += cur.rowcount
    return n


def delete_files(conn: sqlite3.Connection, file_ids: Sequence[int]) -> int:
    """Hard delete rows + dependents (reference manual_refresh.py:200-280)."""
    n = 0
    for chunk in _chunks(list(file_ids)):
        ph = ",".join("?" * len(chunk))
        conn.execute(f"DELETE FROM file_tags WHERE file_id IN ({ph})", list(chunk))
        conn.execute(f"DELETE FROM signatures WHERE file_id IN ({ph})", list(chunk))
        conn.execute(f"DELETE FROM embeddings WHERE file_id IN ({ph})", list(chunk))
        cur = conn.execute(f"DELETE FROM files WHERE id IN ({ph})", list(chunk))
        n += cur.rowcount
    return n


def list_untagged_under_path(conn: sqlite3.Connection, root: str | Path) -> list[sqlite3.Row]:
    """Present files under a root with no tagger signature
    (reference manual_refresh.py:30-180 LIKE pattern)."""
    clause, pattern = path_prefix_clause(root)
    return conn.execute(
        f"""
        SELECT * FROM files
        WHERE is_present = 1 AND {clause}
          AND (tagger_sig IS NULL OR tagger_sig = '')
        ORDER BY path
        """,
        (pattern,),
    ).fetchall()


def clear_tagger_sig(
    conn: sqlite3.Connection,
    file_ids: Sequence[int] | None = None,
    *,
    only_sig: str | None = None,
) -> int:
    """Invalidate tagging state so the next index re-tags
    (reference retag.py:46-96)."""
    if file_ids is None:
        if only_sig is None:
            cur = conn.execute("UPDATE files SET tagger_sig = NULL, last_tagged_at = NULL")
        else:
            cur = conn.execute(
                "UPDATE files SET tagger_sig = NULL, last_tagged_at = NULL WHERE tagger_sig = ?",
                (only_sig,),
            )
        return cur.rowcount
    n = 0
    for chunk in _chunks(list(file_ids)):
        ph = ",".join("?" * len(chunk))
        cur = conn.execute(
            f"UPDATE files SET tagger_sig = NULL, last_tagged_at = NULL WHERE id IN ({ph})",
            list(chunk),
        )
        n += cur.rowcount
    return n


# ---------------------------------------------------------------------------
# tags / tagging writes
# ---------------------------------------------------------------------------


def upsert_tags(
    conn: sqlite3.Connection,
    tags: Iterable[tuple[str, int]],
    *,
    cache: dict[str, int] | None = None,
) -> dict[str, int]:
    """name->id upsert keeping the first-seen category (reference tags.py:10-27).

    Batched: existing names resolve with chunked SELECTs and only genuinely
    new names are inserted (executemany).  ``cache`` (writer-lifetime tag-def
    cache, reference db_writing_standard.py upsert_tags_uncommitted) makes
    repeat flushes skip the table entirely — the per-name RETURNING loop this
    replaces was ~40% of bulk-write wall at 70k files x 30 tags.
    """
    ids: dict[str, int] = {}
    pending: list[tuple[str, int]] = []
    for name, category in tags:
        if cache is not None and name in cache:
            ids[name] = cache[name]
        else:
            pending.append((name, int(category)))
    if pending:
        def _resolve(names: list[str]) -> None:
            for chunk in _chunks(names):
                ph = ",".join("?" * len(chunk))
                for nm, i in conn.execute(
                    f"SELECT name, id FROM tags WHERE name IN ({ph})", list(chunk)
                ):
                    ids[nm] = int(i)

        _resolve([n for n, _ in pending])
        missing = [(n, c) for n, c in pending if n not in ids]
        if missing:
            conn.executemany(
                "INSERT OR IGNORE INTO tags (name, category) VALUES (?, ?)", missing
            )
            _resolve([n for n, _ in missing])
        if cache is not None:
            for n, _ in pending:
                cache[n] = ids[n]
    return ids


@dataclass(frozen=True)
class TaggingItem:
    """One file's tagging result to persist (reference contracts.py DBItem)."""

    file_id: int
    tags: list[tuple[str, float, int]]  # (name, score, category)
    width: int | None = None
    height: int | None = None
    tagger_sig: str | None = None
    tagged_at: float | None = None


def write_tagging_batch(
    conn: sqlite3.Connection,
    items: Sequence[TaggingItem],
    *,
    tag_cache: dict[str, int] | None = None,
) -> None:
    """Single-transaction batch write (reference repository.py:501-575):
    upsert tag defs, replace file_tags per file, update file metadata."""
    if not items:
        return
    all_tags = {(name, cat) for item in items for (name, _s, cat) in item.tags}
    with conn:
        tag_ids = upsert_tags(conn, sorted(all_tags), cache=tag_cache)
        file_ids = [item.file_id for item in items]
        for chunk in _chunks(file_ids):
            ph = ",".join("?" * len(chunk))
            conn.execute(f"DELETE FROM file_tags WHERE file_id IN ({ph})", list(chunk))
        rows = [
            (item.file_id, tag_ids[name], float(score))
            for item in items
            for (name, score, _cat) in item.tags
        ]
        conn.executemany(
            "INSERT OR REPLACE INTO file_tags (file_id, tag_id, score) VALUES (?, ?, ?)", rows
        )
        now = time.time()
        conn.executemany(
            """
            UPDATE files SET width = COALESCE(?, width), height = COALESCE(?, height),
                   tagger_sig = COALESCE(?, tagger_sig),
                   last_tagged_at = COALESCE(?, last_tagged_at), updated_at = ?
            WHERE id = ?
            """,
            [
                (i.width, i.height, i.tagger_sig, i.tagged_at or now, now, i.file_id)
                for i in items
            ],
        )


def tags_for_files(
    conn: sqlite3.Connection, file_ids: Sequence[int]
) -> dict[int, list[tuple[str, float, int]]]:
    """Hydrate (name, score, category) per file in chunks
    (reference repository.py:373-389)."""
    out: dict[int, list[tuple[str, float, int]]] = {fid: [] for fid in file_ids}
    for chunk in _chunks(list(file_ids)):
        ph = ",".join("?" * len(chunk))
        rows = conn.execute(
            f"""
            SELECT ft.file_id, t.name, ft.score, t.category
            FROM file_tags ft JOIN tags t ON t.id = ft.tag_id
            WHERE ft.file_id IN ({ph})
            ORDER BY ft.score DESC, t.name
            """,
            list(chunk),
        ).fetchall()
        for r in rows:
            out[int(r["file_id"])].append((r["name"], float(r["score"]), int(r["category"])))
    return out


# ---------------------------------------------------------------------------
# signatures
# ---------------------------------------------------------------------------


def upsert_signatures(
    conn: sqlite3.Connection, rows: Iterable[tuple[int, int | None, int | None]]
) -> None:
    """(file_id, phash_signed64, dhash_signed64) bulk upsert."""
    conn.executemany(
        """
        INSERT INTO signatures (file_id, phash_u64, dhash_u64) VALUES (?, ?, ?)
        ON CONFLICT(file_id) DO UPDATE SET
            phash_u64 = COALESCE(excluded.phash_u64, signatures.phash_u64),
            dhash_u64 = COALESCE(excluded.dhash_u64, signatures.dhash_u64)
        """,
        list(rows),
    )


def iter_files_for_dup(conn: sqlite3.Connection) -> list[sqlite3.Row]:
    """Present files joined with signatures (reference repository.py:416-454)."""
    return conn.execute(
        """
        SELECT f.id, f.path, f.size, f.width, f.height, s.phash_u64, s.dhash_u64
        FROM files f LEFT JOIN signatures s ON s.file_id = f.id
        WHERE f.is_present = 1
        ORDER BY f.id
        """
    ).fetchall()


def missing_signature_ids(conn: sqlite3.Connection) -> list[tuple[int, str]]:
    return [
        (int(r["id"]), r["path"])
        for r in conn.execute(
            """
            SELECT f.id, f.path FROM files f
            LEFT JOIN signatures s ON s.file_id = f.id
            WHERE f.is_present = 1 AND (s.file_id IS NULL OR s.phash_u64 IS NULL)
            """
        ).fetchall()
    ]


# ---------------------------------------------------------------------------
# embeddings + catalog meta
# ---------------------------------------------------------------------------


def upsert_embeddings(
    conn: sqlite3.Connection,
    rows: Iterable[tuple[int, "object"]],
    *,
    model: str,
) -> None:
    """(file_id, float32 vector) bulk upsert for one embedding model.

    Shared by the embed stage and the async catalog writer (fused tag+embed
    batches carry their vectors through the write queue, since the writer's
    EXCLUSIVE connection owns the catalog during the quiesce window)."""
    import numpy as np

    conn.executemany(
        """
        INSERT INTO embeddings (file_id, model, dim, vector) VALUES (?, ?, ?, ?)
        ON CONFLICT(file_id, model) DO UPDATE SET
            dim = excluded.dim, vector = excluded.vector
        """,
        [
            (int(fid), model, int(np.asarray(v).shape[0]),
             np.asarray(v, np.float32).tobytes())
            for fid, v in rows
        ],
    )


def get_meta(conn: sqlite3.Connection, key: str) -> str | None:
    row = conn.execute("SELECT value FROM meta WHERE key = ?", (key,)).fetchone()
    return None if row is None else str(row[0])


def set_meta(conn: sqlite3.Connection, key: str, value: str) -> None:
    conn.execute(
        "INSERT INTO meta (key, value) VALUES (?, ?) "
        "ON CONFLICT(key) DO UPDATE SET value = excluded.value",
        (key, value),
    )


def ensure_embed_prep(conn: sqlite3.Connection, model: str, prep_key: str) -> bool:
    """Pin the preprocessing geometry stored vectors were computed with.

    Vectors computed under a different prep are NOT comparable (an ANN
    search would silently mix spaces), so a prep change invalidates the
    model's rows — exactly like an embed_dim change does via the dim check.
    Returns True when stale rows were dropped. A catalog with vectors but
    no recorded prep predates this marker: its rows are treated as current
    IF the incoming prep is the plain (non-derived) one, else dropped."""
    meta_key = f"embed_prep:{model}"
    recorded = get_meta(conn, meta_key)
    stale = False
    with conn:
        if recorded is None:
            has_rows = conn.execute(
                "SELECT 1 FROM embeddings WHERE model = ? LIMIT 1", (model,)
            ).fetchone()
            if has_rows and prep_key.startswith("lb"):
                conn.execute("DELETE FROM embeddings WHERE model = ?", (model,))
                stale = True
        elif recorded != prep_key:
            conn.execute("DELETE FROM embeddings WHERE model = ?", (model,))
            stale = True
        set_meta(conn, meta_key, prep_key)
    return stale


def get_embed_prep(conn: sqlite3.Connection, model: str) -> str | None:
    """Recorded prep geometry for a model's stored vectors (None = plain)."""
    return get_meta(conn, f"embed_prep:{model}")


# ---------------------------------------------------------------------------
# thresholds
# ---------------------------------------------------------------------------


def load_tag_thresholds(conn: sqlite3.Connection) -> dict[int, float]:
    """Per-DB search-threshold overrides (reference db/common.py:47-74)."""
    return {
        int(r["category"]): float(r["threshold"])
        for r in conn.execute("SELECT category, threshold FROM tagger_thresholds").fetchall()
    }


def set_tag_threshold(conn: sqlite3.Connection, category: int, threshold: float) -> None:
    with conn:
        conn.execute(
            """
            INSERT INTO tagger_thresholds (category, threshold) VALUES (?, ?)
            ON CONFLICT(category) DO UPDATE SET threshold = excluded.threshold
            """,
            (int(category), float(threshold)),
        )


# ---------------------------------------------------------------------------
# search (SQL fallback / executable spec for the device engine)
# ---------------------------------------------------------------------------

_ORDER_WHITELIST = {
    "relevance": "relevance DESC, f.mtime DESC, f.id",
    "mtime": "f.mtime DESC, f.id",
    "path": "f.path, f.id",
    "id": "f.id",
}


@dataclass
class SearchResult:
    file_id: int
    path: str
    size: int | None
    mtime: float | None
    width: int | None
    height: int | None
    relevance: float
    tags: list[tuple[str, float, int]] = field(default_factory=list)


def search_files(
    conn: sqlite3.Connection,
    where: str,
    params: Sequence[object],
    *,
    positive_tags: Sequence[str] = (),
    thresholds: Mapping[int, float] | None = None,
    order_by: str = "relevance",
    limit: int = 200,
    offset: int = 0,
    hydrate: bool = True,
) -> list[SearchResult]:
    """Relevance-ordered search (reference repository.py:295-408).

    Relevance = SUM(score) over the query's positive tags whose score clears
    the per-category threshold, 0 when no positive tags.
    """
    if order_by not in _ORDER_WHITELIST:
        raise ValueError(f"order_by must be one of {sorted(_ORDER_WHITELIST)}")
    thr = normalize_thresholds(thresholds)
    g = float(thr.get(int(TagCategory.GENERAL), 0.0))
    ch = float(thr.get(int(TagCategory.CHARACTER), 0.0))
    cp = float(thr.get(int(TagCategory.COPYRIGHT), 0.0))
    default = float(thr.get(-1, 0.0))

    if positive_tags:
        ph = ",".join("?" * len(positive_tags))
        cte = f"""
        WITH q AS (
            SELECT ft.file_id AS file_id, SUM(ft.score) AS relevance
            FROM file_tags ft JOIN tags t ON t.id = ft.tag_id
            WHERE t.name IN ({ph})
              AND ft.score >= CASE t.category
                  WHEN {int(TagCategory.GENERAL)} THEN ?
                  WHEN {int(TagCategory.CHARACTER)} THEN ?
                  WHEN {int(TagCategory.COPYRIGHT)} THEN ?
                  ELSE ? END
            GROUP BY ft.file_id
        )
        """
        rel_expr = "COALESCE(q.relevance, 0.0)"
        join = "LEFT JOIN q ON q.file_id = f.id"
        pre_params: list[object] = [*positive_tags, g, ch, cp, default]
    else:
        cte = ""
        rel_expr = "0.0"
        join = ""
        pre_params = []

    sql = f"""
    {cte}
    SELECT f.id, f.path, f.size, f.mtime, f.width, f.height, {rel_expr} AS relevance
    FROM files f {join}
    WHERE f.is_present = 1 AND ({where})
    ORDER BY {_ORDER_WHITELIST[order_by]}
    LIMIT ? OFFSET ?
    """
    rows = conn.execute(sql, [*pre_params, *params, limit, offset]).fetchall()
    results = [
        SearchResult(
            file_id=int(r["id"]), path=r["path"], size=r["size"], mtime=r["mtime"],
            width=r["width"], height=r["height"], relevance=float(r["relevance"]),
        )
        for r in rows
    ]
    if hydrate and results:
        tag_map = tags_for_files(conn, [r.file_id for r in results])
        for r in results:
            r.tags = tag_map.get(r.file_id, [])
    return results


def tag_stats(
    conn: sqlite3.Connection,
    *,
    category: int | None = None,
    name_like: str | None = None,
    thresholds: Mapping[int, float] | None = None,
    limit: int = 1000,
) -> list[sqlite3.Row]:
    """Aggregated per-tag stats (reference ui/tag_stats.py:143-210 SQL)."""
    thr = normalize_thresholds(thresholds)
    g = float(thr.get(int(TagCategory.GENERAL), 0.0))
    ch = float(thr.get(int(TagCategory.CHARACTER), 0.0))
    cp = float(thr.get(int(TagCategory.COPYRIGHT), 0.0))
    default = float(thr.get(-1, 0.0))
    conds = []
    params: list[object] = [g, ch, cp, default]
    if category is not None:
        conds.append("t.category = ?")
        params.append(int(category))
    if name_like:
        conds.append("t.name LIKE ?")
        params.append(f"%{name_like}%")
    where = (" AND " + " AND ".join(conds)) if conds else ""
    params.append(limit)
    return conn.execute(
        f"""
        SELECT t.name, t.category,
               COUNT(DISTINCT ft.file_id) AS file_count,
               AVG(ft.score) AS avg_score, MAX(ft.score) AS max_score
        FROM tags t JOIN file_tags ft ON ft.tag_id = t.id
        WHERE ft.score >= CASE t.category
              WHEN {int(TagCategory.GENERAL)} THEN ?
              WHEN {int(TagCategory.CHARACTER)} THEN ?
              WHEN {int(TagCategory.COPYRIGHT)} THEN ?
              ELSE ? END
        {where}
        GROUP BY t.id ORDER BY file_count DESC, t.name LIMIT ?
        """,
        params,
    ).fetchall()


def autocomplete_tags(
    conn: sqlite3.Connection, prefix: str, *, limit: int = 20
) -> list[tuple[str, int, int]]:
    """(name, category, usage_count) for prefix completion."""
    return [
        (r["name"], int(r["category"]), int(r["n"]))
        for r in conn.execute(
            """
            SELECT t.name, t.category, COUNT(ft.file_id) AS n
            FROM tags t LEFT JOIN file_tags ft ON ft.tag_id = t.id
            WHERE t.name LIKE ? GROUP BY t.id
            ORDER BY n DESC, t.name LIMIT ?
            """,
            (prefix + "%", limit),
        ).fetchall()
    ]
