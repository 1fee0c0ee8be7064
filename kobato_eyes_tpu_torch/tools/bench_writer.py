"""Bulk-write scale benchmark: the full-library tagging write volume.

Counterpart of the repository's ``tools/bench_writer.py``: the write path at
70k files x ~30 tags (~2M file_tags rows) in one run, the workload the
reference needed its TEMP-table staging writer for. Host only, as its
original: the catalog writer (``services/writer.CatalogWriter``) on SQLite,
no device in the loop. Prints one JSON document with rows/s and files/s::

    python -m kobato_eyes_tpu_torch.tools.bench_writer [--files 70000] [--standard]

The catalog goes to a fresh ``ket_bench_writer_*`` directory under the
temporary directory (``TMPDIR``).
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--files", type=int, default=70_000)
    parser.add_argument("--tags-per-file", type=int, default=30)
    parser.add_argument("--vocab", type=int, default=12_000)
    parser.add_argument("--standard", action="store_true",
                        help="WAL profile instead of unsafe-fast")
    args = parser.parse_args(argv)

    # the contracts first: ``services.writer`` and the pipeline package import each other
    from kobato_eyes_tpu_torch.core.pipeline.contracts import WriteItem
    from kobato_eyes_tpu_torch.db.connection import bootstrap, reset_bootstrap_cache
    from kobato_eyes_tpu_torch.db.repository import upsert_file
    from kobato_eyes_tpu_torch.services.writer import CatalogWriter

    tmp = Path(tempfile.mkdtemp(prefix="ket_bench_writer_"))
    db = tmp / "scale.sqlite"
    reset_bootstrap_cache()
    conn = bootstrap(db)
    n = args.files
    t0 = time.perf_counter()
    with conn:
        ids = [
            upsert_file(conn, path=f"/lib/{i:07d}.png", size=1000 + i, mtime=1e9 + i)
            for i in range(n)
        ]
    upsert_s = time.perf_counter() - t0
    conn.close()

    rng = np.random.default_rng(0)
    names = [f"tag_{k}" for k in range(args.vocab)]
    # pre-generate items so producer cost doesn't pollute the writer timing
    now = time.time()
    items = []
    for fid in ids:
        kidx = np.unique(rng.integers(0, args.vocab, size=args.tags_per_file))
        tags = [(names[k], float(rng.uniform(0.1, 1)), int(k % 6)) for k in kidx]
        items.append(WriteItem(file_id=int(fid), tags=tags, width=None, height=None,
                               tagger_sig="scale", tagged_at=now))

    t0 = time.perf_counter()
    writer = CatalogWriter(db, unsafe_fast=not args.standard)
    writer.start()
    for item in items:
        writer.put(item)
    writer.stop(flush=True)
    writer.raise_if_failed()
    write_s = time.perf_counter() - t0

    conn = bootstrap(db)
    count = conn.execute("SELECT COUNT(*) FROM file_tags").fetchone()[0]
    conn.close()
    assert count == sum(len(i.tags) for i in items), "row count mismatch"
    print(json.dumps({
        "metric": "bulk_write_rows_per_sec",
        "value": round(count / write_s, 1),
        "unit": "rows/s",
        "files": n,
        "rows": int(count),
        "write_s": round(write_s, 2),
        "files_per_sec": round(n / write_s, 1),
        "file_upsert_s": round(upsert_s, 2),
        "profile": "standard-wal" if args.standard else "unsafe-fast",
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
