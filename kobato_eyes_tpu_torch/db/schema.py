"""Catalog schema and versioned migrations.

Table layout preserves the reference's data model
(``src/db/schema.py:12-84``: files / tags / file_tags / signatures /
tagger_thresholds) minus the FTS5 shadow table — free-text tag search runs
against the device index instead.  Migrations use ``PRAGMA user_version``
like the reference (:122-177).
"""

from __future__ import annotations

import sqlite3

CURRENT_SCHEMA_VERSION = 2

SCHEMA_STATEMENTS: tuple[str, ...] = (
    """
    CREATE TABLE IF NOT EXISTS files (
        id INTEGER PRIMARY KEY,
        path TEXT NOT NULL UNIQUE,
        size INTEGER,
        mtime REAL,
        sha256 TEXT,
        width INTEGER,
        height INTEGER,
        tagger_sig TEXT,
        last_tagged_at REAL,
        is_present INTEGER NOT NULL DEFAULT 1,
        created_at REAL,
        updated_at REAL
    )
    """,
    """
    CREATE TABLE IF NOT EXISTS tags (
        id INTEGER PRIMARY KEY,
        name TEXT NOT NULL UNIQUE,
        category INTEGER NOT NULL DEFAULT 0
    )
    """,
    """
    CREATE TABLE IF NOT EXISTS file_tags (
        file_id INTEGER NOT NULL REFERENCES files(id) ON DELETE CASCADE,
        tag_id INTEGER NOT NULL REFERENCES tags(id) ON DELETE CASCADE,
        score REAL NOT NULL,
        PRIMARY KEY (file_id, tag_id)
    ) WITHOUT ROWID
    """,
    """
    CREATE TABLE IF NOT EXISTS signatures (
        file_id INTEGER PRIMARY KEY REFERENCES files(id) ON DELETE CASCADE,
        phash_u64 INTEGER,
        dhash_u64 INTEGER
    )
    """,
    """
    CREATE TABLE IF NOT EXISTS tagger_thresholds (
        category INTEGER PRIMARY KEY,
        threshold REAL NOT NULL
    )
    """,
    """
    CREATE TABLE IF NOT EXISTS embeddings (
        file_id INTEGER NOT NULL REFERENCES files(id) ON DELETE CASCADE,
        model TEXT NOT NULL,
        dim INTEGER NOT NULL,
        vector BLOB NOT NULL,
        PRIMARY KEY (file_id, model)
    )
    """,
    """
    CREATE TABLE IF NOT EXISTS meta (
        key TEXT PRIMARY KEY,
        value TEXT NOT NULL
    ) WITHOUT ROWID
    """,
    "CREATE INDEX IF NOT EXISTS idx_files_path ON files(path)",
    "CREATE INDEX IF NOT EXISTS idx_files_present ON files(is_present)",
    "CREATE INDEX IF NOT EXISTS idx_file_tags_tag ON file_tags(tag_id)",
    "CREATE INDEX IF NOT EXISTS idx_tags_name ON tags(name)",
)

# version -> statements applied when upgrading *to* that version.
MIGRATIONS: dict[int, tuple[str, ...]] = {
    # v2: catalog-level key/value provenance (embedding preprocess geometry,
    # so query-time embedders reconstruct the exact prep the index used)
    2: (
        """
        CREATE TABLE IF NOT EXISTS meta (
            key TEXT PRIMARY KEY,
            value TEXT NOT NULL
        ) WITHOUT ROWID
        """,
    ),
}


def ensure_schema(conn: sqlite3.Connection) -> None:
    """Create or migrate the schema in-place (idempotent)."""
    version = conn.execute("PRAGMA user_version").fetchone()[0]
    if version == 0:
        with conn:
            for stmt in SCHEMA_STATEMENTS:
                conn.execute(stmt)
            conn.execute(f"PRAGMA user_version = {CURRENT_SCHEMA_VERSION}")
        return
    while version < CURRENT_SCHEMA_VERSION:
        version += 1
        with conn:
            for stmt in MIGRATIONS.get(version, ()):
                conn.execute(stmt)
            conn.execute(f"PRAGMA user_version = {version}")
