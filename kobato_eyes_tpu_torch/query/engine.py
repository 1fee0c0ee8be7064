"""Device-resident tag index and query evaluator (the hot search path).

Counterpart of ``kobato_eyes_tpu/query/engine.py``: instead of per-file
EXISTS subqueries, tags live on the device as CSR posting lists (row
indices + scores per tag) plus per-category max-score panels.  A query AST
evaluates bottom-up into dense boolean masks over the N-file axis with
torch tensor ops on the epoch's device; relevance is a masked score sum in
host f64 — semantics identical to the SQL backend, which the parity tests
enforce.

An epoch is an immutable snapshot: builds happen off to the side and swap
atomically (the reference's quiesce gate, re-imagined as versioned arrays).

What differs from the JAX engine, and why:

* The mask evaluator runs eagerly, op by op, so there is no compiled
  program and no program cache: the JAX engine's ``_STRUCTURE_CACHE`` and
  ``_BATCHED_STRUCTURE_CACHE`` have no counterpart here, nor has its
  per-(epoch, query) ``_COMPILED_CACHE`` of uploaded operand tables: a
  query's operands are a few host integers and floats, computed anew by
  ``_slot_tables_np`` and never uploaded.  A term's postings
  are the exact host-known slice ``rows_dev[lo:hi]``; the power-of-two
  posting buckets, the clamped ``dynamic_slice`` start and the skip/length
  window existed for XLA's static shapes.  ``n_pad``, ``t_pad``, the padded
  posting arrays and the dummy row stay: packed words, snapshots and a
  file-row-sharded evaluation read them.
* A term mask is a true reduction (``index_add_`` of the hits, then
  ``> 0``): torch has no scatter-max on bool, and a plain indexed store
  with repeated indices is a race.  ``rows_dev`` stays int32 on the device
  (``index_add_`` takes int32 indices).
* The mask is packed into uint8 words (bit ``i`` of word ``j`` is row
  ``8 j + i``): torch's unsigned 32-bit type has no shifts.  The word
  format is internal; ``_unpack_mask`` returns the same boolean mask.
* Gates and thresholds are compared as Python floats already rounded to
  f32, so an f32 score is never promoted to f64 by the comparison.
* Every entry point takes a ``device`` (``None`` means ``cuda`` and raises
  without a GPU).  No evaluation step reads a device value on the host
  before the one copy of the packed words.
"""

from __future__ import annotations

import logging
import sqlite3
import time
import weakref
from dataclasses import dataclass, field
from functools import cached_property
from typing import Mapping, Sequence

import numpy as np
import torch

from kobato_eyes_tpu_torch.device import resolve_device
from kobato_eyes_tpu_torch.models.base import TagCategory
from kobato_eyes_tpu_torch.query.ast import (
    AndExpr,
    CategoryExpr,
    Expr,
    NotExpr,
    OrExpr,
    ScoreExpr,
    TagExpr,
    extract_positive_tag_terms,
    parse_query,
)
from kobato_eyes_tpu_torch.query.sql import normalize_thresholds

logger = logging.getLogger(__name__)

_NUM_CATEGORIES = 6

# The SQL threshold CASE (query/sql.py _THRESHOLD_CASE) only branches on
# these categories; every other category takes the default (-1) threshold.
_CASED_CATEGORIES = frozenset(
    {int(TagCategory.GENERAL), int(TagCategory.CHARACTER), int(TagCategory.COPYRIGHT)}
)


def _case_gate(thr: dict[int, float], cat: int) -> float:
    if cat in _CASED_CATEGORIES:
        return thr.get(cat, 0.0)
    return thr.get(-1, 0.0)


@dataclass(frozen=True, eq=False)  # identity hash/eq: two epochs are never compared tensor by tensor
class TagIndexEpoch:
    """Immutable device snapshot of the (files x tags) score relation."""

    version: int
    # host-side file metadata (ordering + result assembly)
    file_ids: np.ndarray  # (N,) int64
    mtimes: np.ndarray  # (N,) float64
    sizes: np.ndarray  # (N,) int64
    paths: list[str]
    # tag vocabulary
    tag_names: list[str]
    tag_cats: np.ndarray  # (T,) int32
    name_to_tid: dict[str, int]
    # CSR postings, tag-major (device + host mirrors; the host copy serves
    # f64 relevance sums that must order exactly like SQLite's SUM).
    # Device arrays are PADDED to power-of-two buckets (pad entries point at
    # the dummy row n_pad-1 / dummy tag t_pad-1): a delta epoch with slightly
    # different sizes keeps the same padded shapes, and the packed mask
    # words divide evenly.
    offsets: np.ndarray  # (T+1,) int64, host
    rows_dev: torch.Tensor  # (nnz_pad,) int32
    scores_dev: torch.Tensor  # (nnz_pad,) float32
    rows_np: np.ndarray  # (nnz,) int32, host
    scores_np: np.ndarray  # (nnz,) float64, host
    # per-category panels (device, padded to n_pad rows)
    cat_max_dev: torch.Tensor  # (n_pad, 6) float32, 0 where absent
    cat_present_dev: torch.Tensor  # (n_pad, 6) bool
    # per-file score extrema over ALL postings (device, padded): answer
    # bare score>=/>/<=/< EXISTS terms without a 30M-entry scatter
    smax_dev: torch.Tensor = None  # (n_pad,) float32, -inf where no postings
    smin_dev: torch.Tensor = None  # (n_pad,) float32, +inf where no postings
    n_pad: int = 0
    t_pad: int = 0
    built_at: float = field(default_factory=time.time)

    @property
    def device(self) -> torch.device:
        """Where the epoch's tensors live."""
        return self.rows_dev.device

    @property
    def num_files(self) -> int:
        return len(self.file_ids)

    @cached_property
    def path_ranks(self) -> np.ndarray:
        """Order-isomorphic integer ranks of ``paths``.

        Lexsorting these equals lexsorting the raw strings (np U-dtype
        compares code points; SQLite BINARY collation is UTF-8 memcmp, and
        UTF-8 preserves code-point order) — same trick as the dup engine's
        sort keys.  Computed once per epoch on first path-ordered query;
        a 1M-file path ORDER BY then costs an int gather, not a
        per-hit Python list comprehension.  (cached_property writes
        straight into __dict__, so the frozen dataclass stays frozen; a
        concurrent double-compute is benign.)
        """
        return np.unique(np.asarray(self.paths), return_inverse=True)[1]

    @property
    def num_tags(self) -> int:
        return len(self.tag_names)

    @property
    def nnz(self) -> int:
        return int(self.offsets[-1]) if len(self.offsets) else 0


def _pad_bucket(x: int) -> int:
    """Smallest power of two strictly greater than ``x`` (min 256)."""
    return 1 << max(8, int(np.ceil(np.log2(max(int(x), 1) + 1))))


def _to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(array)).to(device)


def _device_postings(
    r_idx: np.ndarray, sc: np.ndarray, t_idx: np.ndarray, n: int, t_count: int,
    device: torch.device,
) -> tuple[int, int, torch.Tensor, torch.Tensor]:
    """Pad postings to bucketed shapes and place on device.

    Padding entries point at the dummy row (n_pad-1 >= n) with score 0 so
    they can never contribute to a real file's mask.  Tag identity is
    positional (tag-major CSR + host ``offsets``); no per-entry tag-id array
    ships to the device — it would be a third of the upload and device
    memory for something no evaluation reads.
    """
    from kobato_eyes_tpu_torch.utils.metrics import metrics

    nnz = len(r_idx)
    n_pad = _pad_bucket(n)
    t_pad = _pad_bucket(t_count)
    nnz_pad = _pad_bucket(nnz)
    # empty + slice-fill (a np.full over nnz_pad writes the whole 2x-padded
    # array twice; only the tail needs the dummy fill)
    rows = np.empty(nnz_pad, dtype=np.int32)
    rows[:nnz] = r_idx
    rows[nnz:] = n_pad - 1
    scores = np.empty(nnz_pad, dtype=np.float32)
    scores[:nnz] = sc
    scores[nnz:] = 0.0
    with metrics.timer("epoch.upload"):
        rows_dev = torch.from_numpy(rows).to(device)
        scores_dev = torch.from_numpy(scores).to(device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    return n_pad, t_pad, rows_dev, scores_dev


def _pad_rows(x: torch.Tensor, n_pad: int, value) -> torch.Tensor:
    """``x`` with its first axis padded to ``n_pad`` rows of ``value``."""
    n = x.shape[0]
    if n == n_pad:
        return x
    out = x.new_full((n_pad, *x.shape[1:]), value)
    out[:n] = x
    return out


def _pad_panels(
    cat_max_dev: torch.Tensor, cat_present_dev: torch.Tensor, n_pad: int
) -> tuple[torch.Tensor, torch.Tensor]:
    return _pad_rows(cat_max_dev, n_pad, 0.0), _pad_rows(cat_present_dev, n_pad, False)


def _pad_extrema(smax_dev: torch.Tensor, smin_dev: torch.Tensor, n_pad: int):
    return (
        _pad_rows(smax_dev, n_pad, float("-inf")),
        _pad_rows(smin_dev, n_pad, float("inf")),
    )


def _assemble_epoch(
    *,
    version: int,
    file_ids: np.ndarray,
    mtimes: np.ndarray,
    sizes: np.ndarray,
    paths: list[str],
    tag_names: list[str],
    tag_cats: np.ndarray,
    t_idx: np.ndarray,  # (nnz,) tag row per entry
    r_idx: np.ndarray,  # (nnz,) file row per entry
    sc: np.ndarray,  # (nnz,) float32 scores
    presorted: bool = False,  # t_idx already tag-sorted (delta merge path)
    panels: tuple | None = None,  # precomputed device panels (cat + extrema)
    device=None,
) -> TagIndexEpoch:
    from kobato_eyes_tpu_torch.utils.metrics import metrics

    device = resolve_device(device)
    if not presorted:
        with metrics.timer("epoch.sort"):
            order = np.argsort(t_idx, kind="stable")
            t_idx, r_idx, sc = t_idx[order], r_idx[order], sc[order]
    offsets = np.zeros(len(tag_names) + 1, dtype=np.int64)
    # bincount instead of np.add.at (ufunc.at is ~20x slower at 10M entries)
    counts = np.bincount(t_idx, minlength=len(tag_names))
    offsets[1:] = np.cumsum(counts)

    n = len(file_ids)
    if panels is not None:
        cat_max_dev, cat_present_dev, smax_dev, smin_dev = panels
    else:
        cat_max, cat_present, smax, smin = _category_panels(n, t_idx, r_idx, sc, tag_cats)
        cat_max_dev = _to_device(cat_max, device)
        cat_present_dev = _to_device(cat_present, device)
        smax_dev = _to_device(smax, device)
        smin_dev = _to_device(smin, device)

    n_pad, t_pad, rows_dev, scores_dev = _device_postings(
        r_idx.astype(np.int32, copy=False), sc.astype(np.float32), t_idx, n, len(tag_names),
        device,
    )
    cat_max_dev, cat_present_dev = _pad_panels(cat_max_dev, cat_present_dev, n_pad)
    smax_dev, smin_dev = _pad_extrema(smax_dev, smin_dev, n_pad)

    return TagIndexEpoch(
        version=version,
        file_ids=file_ids,
        mtimes=mtimes,
        sizes=sizes,
        paths=paths,
        tag_names=tag_names,
        tag_cats=tag_cats,
        name_to_tid={name: i for i, name in enumerate(tag_names)},
        offsets=offsets,
        rows_dev=rows_dev,
        scores_dev=scores_dev,
        rows_np=r_idx.astype(np.int32, copy=False),
        scores_np=sc.astype(np.float64, copy=False),
        cat_max_dev=cat_max_dev,
        cat_present_dev=cat_present_dev,
        smax_dev=smax_dev,
        smin_dev=smin_dev,
        n_pad=n_pad,
        t_pad=t_pad,
    )


def _category_panels(
    n: int,
    t_idx: np.ndarray,
    r_idx: np.ndarray,
    sc: np.ndarray,
    tag_cats: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-(file, category) max-score + presence panels, and per-file score
    extrema over ALL postings (smax/smin: bare score-term EXISTS semantics,
    category-independent)."""
    cat_max = np.zeros((n, _NUM_CATEGORIES), dtype=np.float32)
    cat_present = np.zeros((n, _NUM_CATEGORIES), dtype=bool)
    smax = np.full(n, -np.inf, dtype=np.float32)
    smin = np.full(n, np.inf, dtype=np.float32)
    if len(t_idx):
        cats_of_entries = tag_cats[t_idx]
        valid = (cats_of_entries >= 0) & (cats_of_entries < _NUM_CATEGORIES)
        # grouped max via sort + reduceat (np.maximum.at dominated 300k builds)
        cell = r_idx[valid].astype(np.int64) * _NUM_CATEGORIES + cats_of_entries[valid]
        sv = sc[valid].astype(np.float32)
        corder = np.argsort(cell, kind="stable")
        cell_s = cell[corder]
        sv_s = sv[corder]
        if len(cell_s):
            starts = np.concatenate([[0], np.nonzero(np.diff(cell_s))[0] + 1])
            maxima = np.maximum.reduceat(sv_s, starts)
            cells = cell_s[starts]
            cat_max.reshape(-1)[cells] = maxima
            cat_present.reshape(-1)[cells] = True
            # per-row extrema ride the same row-major order (cell // 6 = row)
            rows_s = (cell_s // _NUM_CATEGORIES).astype(np.int64)
            rstarts = np.concatenate([[0], np.nonzero(np.diff(rows_s))[0] + 1])
            rrows = rows_s[rstarts]
            smax[rrows] = np.maximum.reduceat(sv_s, rstarts)
            smin[rrows] = np.minimum.reduceat(sv_s, rstarts)
        if not valid.all():
            # out-of-range categories (never produced by this engine, but the
            # catalog is open): exact merge of the tiny invalid subset
            ri = r_idx[~valid]
            si = sc[~valid].astype(np.float32)
            np.maximum.at(smax, ri, si)
            np.minimum.at(smin, ri, si)
    return cat_max, cat_present, smax, smin


def _raw_cursor(conn: sqlite3.Connection) -> sqlite3.Cursor:
    """Cursor yielding plain tuples: sqlite3.Row item access costs ~5x more
    and dominates multi-million-row epoch fetches."""
    cur = conn.cursor()
    cur.row_factory = None  # type: ignore[assignment]
    return cur


# SQLite variable limit safety: IN(...) lists are chunked like
# db/repository._chunks so bulk retags of >900 files cannot blow the
# per-statement variable cap (999 on older builds).
_SQL_ID_CHUNK = 900


def _fetch_by_id_chunks(
    conn: sqlite3.Connection, sql_tmpl: str, ids: Sequence[int]
) -> list:
    """Run ``sql_tmpl.format(ph=...)`` over 900-id chunks, concatenating rows."""
    rows: list = []
    ids = list(ids)
    for start in range(0, len(ids), _SQL_ID_CHUNK):
        chunk = ids[start : start + _SQL_ID_CHUNK]
        ph = ",".join("?" * len(chunk))
        rows.extend(_raw_cursor(conn).execute(sql_tmpl.format(ph=ph), chunk).fetchall())
    return rows


def _db_file_path(conn: sqlite3.Connection) -> str | None:
    """Filesystem path of the main database, or None (e.g. :memory:)."""
    for _, name, path in conn.execute("PRAGMA database_list"):
        if name == "main":
            return path or None
    return None


def _fetch_file_tag_arrays_native(conn: sqlite3.Connection) -> tuple | None:
    """Full-table fetch through the C sqlite3 API (no per-row Python).

    The Python binding's fetchall creates one tuple per row — measured 32 s
    alone at 8.8M postings; the native walk is ~20x faster.  Reads on a
    separate READ-ONLY connection (committed state; epoch builds run under
    the single-writer discipline).  Returns None to fall back to the Python
    path (: memory: DBs, row-count race, missing toolchain).
    """
    import ctypes

    path = _db_file_path(conn)
    if not path:
        return None
    try:
        from kobato_eyes_tpu_torch.native.build import load_native_library

        lib = load_native_library(
            "catalog_fetch", extra_link_args=("-l:libsqlite3.so.0",)
        )
    except Exception:  # noqa: BLE001 — native is an accelerator, never required
        logger.warning("native catalog fetch unavailable; using Python path", exc_info=True)
        return None
    fn = lib.ket_fetch_file_tags
    fn.restype = ctypes.c_longlong
    fn.argtypes = [
        ctypes.c_char_p, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_double),
    ]
    (expected,) = conn.execute("SELECT COUNT(*) FROM file_tags").fetchone()
    cap = int(expected) + 1024  # slack for a concurrent commit; -4 => fallback
    fid = np.empty(cap, dtype=np.int64)
    tid = np.empty(cap, dtype=np.int64)
    sc = np.empty(cap, dtype=np.float64)
    n = fn(
        str(path).encode(), cap,
        fid.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        tid.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        sc.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if n < 0:
        logger.warning("native catalog fetch failed (rc=%d); using Python path", n)
        return None
    return fid[:n], tid[:n], sc[:n]


def _fetch_file_tag_arrays(
    conn: sqlite3.Connection, where: str = "", params: Sequence = ()
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """file_tags -> (file_id, tag_id, score) arrays without per-row Python."""
    # The side connection sees committed state only — stay on the Python
    # path while the caller holds an open transaction (its own uncommitted
    # writes must be visible to the build for consistency with the files/
    # tags reads above it).
    if not where and not conn.in_transaction:
        native = _fetch_file_tag_arrays_native(conn)
        if native is not None:
            return native
    rows = _raw_cursor(conn).execute(
        f"SELECT file_id, tag_id, score FROM file_tags {where}", list(params)
    ).fetchall()
    m = len(rows)
    fid = np.fromiter((r[0] for r in rows), dtype=np.int64, count=m)
    tid = np.fromiter((r[1] for r in rows), dtype=np.int64, count=m)
    # f64: the host copy must sum relevance exactly like SQLite's SUM
    sc = np.fromiter((r[2] for r in rows), dtype=np.float64, count=m)
    return fid, tid, sc


def _data_version(conn: sqlite3.Connection) -> int:
    """SQLite's cross-connection change counter (PRAGMA data_version) —
    bumps whenever ANOTHER connection commits, including the side connection
    used by the native catalog fetch's file."""
    return int(_raw_cursor(conn).execute("PRAGMA data_version").fetchone()[0])


def build_epoch(conn: sqlite3.Connection, *, version: int = 0, device=None) -> TagIndexEpoch:
    """Snapshot the catalog's present files into a device epoch on ``device``
    (``None``: cuda).

    Epoch builds normally run under the single-writer discipline, but the
    native file_tags fetch reads the DB file on a separate connection —
    a writer committing between the files/tags reads and that fetch would
    yield a mixed-state epoch.  Detect it via PRAGMA data_version around
    the whole read set; on a detected concurrent commit, rebuild once
    inside a read transaction (Python fetch path), which WAL snapshots.
    """
    device = resolve_device(device)
    dv0 = _data_version(conn)
    epoch = _build_epoch_reads(conn, version=version, device=device)
    if _data_version(conn) == dv0:
        return epoch
    logger.warning(
        "concurrent commit detected during epoch build; retrying under a read transaction"
    )
    if conn.in_transaction:  # caller already holds a snapshot; keep theirs
        return _build_epoch_reads(conn, version=version, device=device)
    _raw_cursor(conn).execute("BEGIN")
    try:
        # any read inside the transaction pins the WAL snapshot; the Python
        # fetch path is used automatically (conn.in_transaction gate)
        return _build_epoch_reads(conn, version=version, device=device)
    finally:
        conn.rollback()


def _build_epoch_reads(conn: sqlite3.Connection, *, version: int, device: torch.device) -> TagIndexEpoch:
    t0 = time.perf_counter()
    files = _raw_cursor(conn).execute(
        "SELECT id, path, mtime, size FROM files WHERE is_present = 1 ORDER BY id"
    ).fetchall()
    nf = len(files)
    file_ids = np.fromiter((r[0] for r in files), dtype=np.int64, count=nf)
    paths = [r[1] for r in files]
    mtimes = np.fromiter((r[2] or 0.0 for r in files), dtype=np.float64, count=nf)
    sizes_arr = np.fromiter((r[3] or 0 for r in files), dtype=np.int64, count=nf)

    tags = _raw_cursor(conn).execute(
        "SELECT id, name, category FROM tags ORDER BY id"
    ).fetchall()
    nt = len(tags)
    tag_db_ids = np.fromiter((r[0] for r in tags), dtype=np.int64, count=nt)
    tag_names = [r[1] for r in tags]
    tag_cats = np.fromiter((r[2] for r in tags), dtype=np.int32, count=nt)

    fid, tid_db, sc = _fetch_file_tag_arrays(conn)
    # vectorized id -> row mapping (both id arrays are sorted, unique)
    if nf and nt and len(fid):
        r_idx = np.searchsorted(file_ids, fid)
        t_idx = np.searchsorted(tag_db_ids, tid_db)
        valid = (r_idx < nf) & (t_idx < nt)
        valid &= file_ids[np.minimum(r_idx, nf - 1)] == fid
        valid &= tag_db_ids[np.minimum(t_idx, nt - 1)] == tid_db
    else:
        r_idx = np.zeros(0, dtype=np.int64)
        t_idx = np.zeros(0, dtype=np.int64)
        valid = np.zeros(len(fid), dtype=bool)[:0]
        fid, sc = fid[:0], sc[:0]
        valid = np.zeros(0, dtype=bool)

    epoch = _assemble_epoch(
        version=version, file_ids=file_ids, mtimes=mtimes, sizes=sizes_arr,
        paths=paths, tag_names=tag_names, tag_cats=tag_cats,
        t_idx=t_idx[valid], r_idx=r_idx[valid].astype(np.int32), sc=sc[valid],
        device=device,
    )
    logger.info(
        "epoch v%d built: files=%d tags=%d nnz=%d in %.3fs",
        version, nf, nt, int(valid.sum()), time.perf_counter() - t0,
    )
    return epoch


def update_epoch(
    conn: sqlite3.Connection,
    prev: TagIndexEpoch,
    *,
    changed_file_ids: Sequence[int],
    version: int,
    device=None,
) -> TagIndexEpoch:
    """Delta build: re-read only the changed/added/removed files.  The new
    epoch lands on ``device`` (``None``: the previous epoch's device).

    The incremental engine (SURVEY §7 step 7): postings of changed files are
    dropped from the previous CSR and re-fetched; files absent from the
    catalog (deleted / soft-deleted) leave the file axis.  New tags extend
    the vocabulary.  Cost scales with |changes| + nnz (one argsort), not
    with a full catalog re-read.
    """
    t0 = time.perf_counter()
    device = prev.device if device is None else resolve_device(device)
    changed = np.unique(np.asarray(list(changed_file_ids), dtype=np.int64))

    # current state of the changed ids (which still exist & are present)
    cur_rows = _fetch_by_id_chunks(
        conn,
        "SELECT id, path, mtime, size FROM files WHERE is_present = 1 AND id IN ({ph})",
        changed.tolist(),
    ) if len(changed) else []
    alive = {int(r[0]): (r[1], float(r[2] or 0.0), int(r[3] or 0)) for r in cur_rows}

    # new file axis: previous files minus changed-and-gone, plus changed-and-alive
    prev_ids = prev.file_ids
    keep_mask = ~np.isin(prev_ids, changed)
    kept_ids = prev_ids[keep_mask]
    add_ids = np.array(sorted(alive), dtype=np.int64)
    file_ids = np.concatenate([kept_ids, add_ids])
    order = np.argsort(file_ids, kind="stable")
    file_ids = file_ids[order]

    # File metadata for the new axis, vectorized (a Python loop over the
    # full axis costs seconds at 300k files; every file is either kept from
    # prev or in the tiny `alive` set)
    n_new = len(file_ids)
    add_pos = np.searchsorted(file_ids, add_ids)
    kept_pos = np.ones(n_new, dtype=bool)
    kept_pos[add_pos] = False
    old_idx = np.searchsorted(prev_ids, file_ids[kept_pos])
    mtimes_all = np.empty(n_new, dtype=np.float64)
    sizes_all = np.empty(n_new, dtype=np.int64)
    paths_arr = np.empty(n_new, dtype=object)
    mtimes_all[kept_pos] = prev.mtimes[old_idx]
    sizes_all[kept_pos] = prev.sizes[old_idx]
    paths_arr[kept_pos] = np.asarray(prev.paths, dtype=object)[old_idx]
    if len(add_ids):
        meta = [alive[int(f)] for f in add_ids]
        paths_arr[add_pos] = [m[0] for m in meta]
        mtimes_all[add_pos] = [m[1] for m in meta]
        sizes_all[add_pos] = [m[2] for m in meta]
    paths_all = paths_arr.tolist()

    # refreshed tag vocabulary (append-only in practice)
    tags = _raw_cursor(conn).execute("SELECT id, name, category FROM tags ORDER BY id").fetchall()
    nt = len(tags)
    tag_db_ids = np.fromiter((r[0] for r in tags), dtype=np.int64, count=nt)
    tag_names = [r[1] for r in tags]
    tag_cats = np.fromiter((r[2] for r in tags), dtype=np.int32, count=nt)
    # previous tid -> new tid (names are unique and stable)
    name_pos = {n: i for i, n in enumerate(tag_names)}
    prev_tid_map = np.array([name_pos.get(n, -1) for n in prev.tag_names], dtype=np.int64)

    from kobato_eyes_tpu_torch.utils.metrics import metrics as _metrics

    # Vocabulary append-only fast path: prior tags must map to identical new
    # tids AND keep their categories (the reused per-category panels bake the
    # old categories in); then surviving postings stay tag-sorted and new
    # postings MERGE in instead of globally re-sorting 10M+ entries.
    np_prev = len(prev_tid_map)
    vocab_append_only = (
        np_prev <= nt
        and bool((prev_tid_map == np.arange(np_prev)).all())
        and bool((tag_cats[:np_prev] == prev.tag_cats).all())
    )
    # Retag fast path: when no file entered or left the axis (the common
    # delta — tags changed in place), old row indices stay valid and the
    # 8.8M-entry row-remap gather is skipped entirely.
    same_file_axis = np.array_equal(file_ids, prev_ids)

    # surviving postings from the previous epoch (host mirrors keep f64).
    # Every pass below is O(nnz) on the host; the point of this section is
    # to do as FEW of those passes as possible (measured at 300k/8.8M nnz:
    # the merge, not the device upload, is the delta's cost).
    _t_merge = time.perf_counter()
    prev_rows = prev.rows_np
    prev_scores = prev.scores_np
    prev_tids = np.repeat(
        np.arange(prev.num_tags, dtype=np.int64), np.diff(prev.offsets)
    )
    surv_idx = np.flatnonzero(keep_mask[prev_rows])
    s_rows_old = prev_rows[surv_idx]
    s_sc = prev_scores[surv_idx]
    if vocab_append_only:
        s_t = prev_tids[surv_idx]  # identity tid map
    else:
        s_t = prev_tid_map[prev_tids[surv_idx]]
        ok_t = s_t >= 0
        s_rows_old, s_t, s_sc = s_rows_old[ok_t], s_t[ok_t], s_sc[ok_t]
    if same_file_axis:
        s_rows = s_rows_old  # already int32, rows unchanged
    else:
        old_to_new = np.searchsorted(file_ids, prev_ids).astype(np.int32)
        s_rows = old_to_new[s_rows_old]

    # fresh postings for the changed-and-alive files
    if len(add_ids):
        rows = _fetch_by_id_chunks(
            conn,
            "SELECT file_id, tag_id, score FROM file_tags WHERE file_id IN ({ph})",
            add_ids.tolist(),
        )
        m = len(rows)
        fid = np.fromiter((r[0] for r in rows), dtype=np.int64, count=m)
        tid_db = np.fromiter((r[1] for r in rows), dtype=np.int64, count=m)
        sc = np.fromiter((r[2] for r in rows), dtype=np.float64, count=m)
        n_rows = np.searchsorted(file_ids, fid).astype(np.int32)
        n_t = np.searchsorted(tag_db_ids, tid_db)
        if vocab_append_only:
            norder = np.argsort(n_t, kind="stable")
            n_t, n_rows, sc, fid = n_t[norder], n_rows[norder], sc[norder], fid[norder]
            # one shared destination map instead of three np.insert calls
            # (np.insert rebuilds its index bookkeeping per call)
            total = len(s_t) + m
            new_pos = np.searchsorted(s_t, n_t, side="right") + np.arange(m)
            old_pos_mask = np.ones(total, dtype=bool)
            old_pos_mask[new_pos] = False
            t_idx = np.empty(total, dtype=s_t.dtype)
            r_idx = np.empty(total, dtype=np.int32)
            scores = np.empty(total, dtype=np.float64)
            t_idx[new_pos] = n_t
            r_idx[new_pos] = n_rows
            scores[new_pos] = sc
            t_idx[old_pos_mask] = s_t
            r_idx[old_pos_mask] = s_rows
            scores[old_pos_mask] = s_sc
        else:
            t_idx = np.concatenate([s_t, n_t])
            r_idx = np.concatenate([s_rows, n_rows])
            scores = np.concatenate([s_sc, sc])
    else:
        t_idx, r_idx, scores = s_t, s_rows, s_sc

    _metrics.observe("epoch.delta.host_merge", time.perf_counter() - _t_merge)
    _t_panels = time.perf_counter()
    # Panels: gather unchanged rows from the previous epoch ON DEVICE, set
    # the changed/added rows from their (tiny) postings.
    panels = None
    if vocab_append_only:
        n_new = len(file_ids)
        new_to_old = np.searchsorted(prev_ids, file_ids)
        new_to_old = np.minimum(new_to_old, max(len(prev_ids) - 1, 0))
        from_prev = (
            (prev_ids[new_to_old] == file_ids) & ~np.isin(file_ids, add_ids)
            if len(prev_ids)
            else np.zeros(n_new, dtype=bool)
        )
        src = np.where(from_prev, new_to_old, 0).astype(np.int64)
        # gathers make fresh tensors: the previous epoch's are never written
        # (old readers keep them)
        keep_dev = _to_device(from_prev, device)
        keep_col = keep_dev[:, None]
        src_dev = _to_device(src, prev.device)
        cat_max_dev = torch.where(keep_col, prev.cat_max_dev[src_dev].to(device), 0.0)
        cat_present_dev = prev.cat_present_dev[src_dev].to(device) & keep_col
        smax_dev = torch.where(keep_dev, prev.smax_dev[src_dev].to(device), float("-inf"))
        smin_dev = torch.where(keep_dev, prev.smin_dev[src_dev].to(device), float("inf"))
        if len(add_ids):
            # panels for just the added rows, computed densely on host
            add_rows_new = np.searchsorted(file_ids, add_ids)
            local = np.searchsorted(add_ids, fid).astype(np.int32)
            amax, apresent, asmax, asmin = _category_panels(
                len(add_ids), n_t, local, sc, tag_cats
            )
            add_dev = _to_device(add_rows_new.astype(np.int64), device)  # unique rows
            cat_max_dev.index_copy_(0, add_dev, _to_device(amax, device))
            cat_present_dev.index_copy_(0, add_dev, _to_device(apresent, device))
            smax_dev.index_copy_(0, add_dev, _to_device(asmax, device))
            smin_dev.index_copy_(0, add_dev, _to_device(asmin, device))
        panels = (cat_max_dev, cat_present_dev, smax_dev, smin_dev)

    _metrics.observe("epoch.delta.panels", time.perf_counter() - _t_panels)
    _metrics.observe("epoch.delta.merge", time.perf_counter() - _t_merge)

    epoch = _assemble_epoch(
        version=version, file_ids=file_ids, mtimes=mtimes_all, sizes=sizes_all,
        paths=paths_all, tag_names=tag_names, tag_cats=tag_cats,
        t_idx=t_idx, r_idx=r_idx, sc=scores,
        presorted=vocab_append_only, panels=panels, device=device,
    )
    logger.info(
        "epoch v%d delta: files=%d (+%d changed) nnz=%d in %.3fs",
        version, len(file_ids), len(changed), len(t_idx), time.perf_counter() - t0,
    )
    return epoch


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------


@dataclass
class DeviceSearchResult:
    file_id: int
    path: str
    mtime: float
    size: int
    relevance: float


_ORDERINGS = ("relevance", "mtime", "path", "id")

# epoch -> ids of meshes that cannot shard it (search_epoch's memoized
# verdict); weak keys, so a superseded epoch drops its verdicts
_UNSHARDABLE_VERDICTS: "weakref.WeakKeyDictionary[TagIndexEpoch, set]" = weakref.WeakKeyDictionary()


def _lower_structure(
    expr: Expr | None, slots: dict[str, int], score_vals: list[float]
) -> tuple:
    """AST -> hashable structure; collects tag slots and score thresholds."""
    if expr is None:
        return ("all",)
    if isinstance(expr, TagExpr):
        k = slots.setdefault(expr.name, len(slots))
        return ("tag", k)
    if isinstance(expr, CategoryExpr):
        return ("cat", int(expr.category))
    if isinstance(expr, ScoreExpr):
        score_vals.append(float(expr.threshold))
        return ("score", expr.op, len(score_vals) - 1)
    if isinstance(expr, NotExpr):
        return ("not", _lower_structure(expr.operand, slots, score_vals))
    if isinstance(expr, AndExpr):
        return (
            "and",
            _lower_structure(expr.left, slots, score_vals),
            _lower_structure(expr.right, slots, score_vals),
        )
    if isinstance(expr, OrExpr):
        return (
            "or",
            _lower_structure(expr.left, slots, score_vals),
            _lower_structure(expr.right, slots, score_vals),
        )
    raise TypeError(f"unhandled expression {expr!r}")


def _slot_tables_np(
    epoch: TagIndexEpoch,
    expr: Expr | None,
    thr: dict[int, float],
    *,
    offsets: np.ndarray | None = None,
):
    """Host-side operands for one query on one epoch.

    Returns (structure, starts, lens, gates, score_thr, cat_gate): the
    query's structure (tag names abstracted into slot indices, score
    thresholds into operand slots), per slot the start and length of the
    tag's postings in the tag-major CSR and its f32 threshold gate, the f32
    score thresholds and the six f32 category gates. ``offsets``: another
    CSR's tag offsets over the same vocabulary (a row shard's,
    ``query/sharded.py``); the epoch's own by default.
    """
    if offsets is None:
        offsets = epoch.offsets
    slots: dict[str, int] = {}
    score_vals: list[float] = []
    structure = _lower_structure(expr, slots, score_vals)
    starts = np.zeros(len(slots), dtype=np.int64)
    lens = np.zeros(len(slots), dtype=np.int64)
    gates = np.zeros(len(slots), dtype=np.float32)
    for name, k in slots.items():
        tid = epoch.name_to_tid.get(name)
        if tid is None:
            continue  # unknown tag: zero-length slice, mask stays all-False
        lo = int(offsets[tid])
        starts[k] = lo
        lens[k] = int(offsets[tid + 1]) - lo
        gates[k] = _case_gate(thr, int(epoch.tag_cats[tid]))
    score_thr = np.asarray(score_vals or [0.0], dtype=np.float32)
    cat_gate = np.asarray(
        [thr.get(c, 0.0) for c in range(_NUM_CATEGORIES)], dtype=np.float32
    )
    return (structure, starts, lens, gates, score_thr, cat_gate)


def _hit_rows(rows: torch.Tensor, hit: torch.Tensor, npad: int) -> torch.Tensor:
    """(npad,) bool: True at every row that some posting with ``hit`` names.
    A sum of the hits per row, so repeated rows cannot race."""
    counts = torch.zeros(npad, dtype=torch.int32, device=rows.device)
    counts.index_add_(0, rows, hit.to(torch.int32))
    return counts > 0


def _mask_words(epoch: TagIndexEpoch, tables: tuple) -> torch.Tensor:
    """Evaluate one query's operands on the epoch's device; returns the file
    mask over ``n_pad`` rows packed into ``n_pad // 8`` uint8 words (still on
    the device: nothing here waits for it). ``epoch`` may be a row shard
    (``query/sharded._Shard``), which carries the same fields.

    Term postings are CONTIGUOUS slices of the tag-major CSR, so each term
    mask touches only the queried tag's entries; only the ``score = t`` term
    walks all postings.
    """
    structure, starts, lens, gates, score_thr, cat_gate = tables
    npad = epoch.n_pad
    dev = epoch.device
    term_masks: list[torch.Tensor] = []
    for lo, length, gate in zip(starts.tolist(), lens.tolist(), gates.tolist()):
        sl_rows = epoch.rows_dev[lo : lo + length]
        hit = epoch.scores_dev[lo : lo + length] >= gate  # f32 >= f32
        term_masks.append(_hit_rows(sl_rows, hit, npad))
    thresholds = score_thr.tolist()  # f32 values as Python floats
    cat_gates = cat_gate.tolist()

    def ev(node: tuple) -> torch.Tensor:
        kind = node[0]
        if kind == "all":
            return torch.ones(npad, dtype=torch.bool, device=dev)
        if kind == "tag":
            return term_masks[node[1]]
        if kind == "cat":
            c = node[1]
            return epoch.cat_present_dev[:, c] & (epoch.cat_max_dev[:, c] >= cat_gates[c])
        if kind == "score":
            # bare score EXISTS term (sql.py: no category CASE): the
            # per-file extrema panels answer every inequality without a
            # full-postings scatter (30M+ entries at 1M files); exact
            # equality keeps the scatter formulation
            op, t = node[1], thresholds[node[2]]
            if op == ">=":
                return epoch.smax_dev >= t
            if op == ">":
                return epoch.smax_dev > t
            if op == "<=":
                return epoch.smin_dev <= t
            if op == "<":
                return epoch.smin_dev < t
            return _hit_rows(epoch.rows_dev, epoch.scores_dev == t, npad)
        if kind == "not":
            return ~ev(node[1])
        if kind == "and":
            return ev(node[1]) & ev(node[2])
        if kind == "or":
            return ev(node[1]) | ev(node[2])
        raise TypeError(f"unhandled structure node {node!r}")

    mask = ev(structure)
    # pack to uint8 words: the copy to the host is npad/8 bytes, not npad
    bits = mask.view(-1, 8).to(torch.int32) * _bit_weights(dev)
    return bits.sum(dim=1).to(torch.uint8)


_BIT_WEIGHTS: dict[torch.device, torch.Tensor] = {}


def _bit_weights(device: torch.device) -> torch.Tensor:
    w = _BIT_WEIGHTS.get(device)
    if w is None:
        w = _BIT_WEIGHTS[device] = torch.tensor(
            [1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.int32, device=device
        )
    return w


def _unpack_mask(words: np.ndarray, n: int) -> np.ndarray:
    """uint8 words (bit i of word j is row 8 j + i) -> (n,) bool."""
    return np.unpackbits(words, bitorder="little")[:n].astype(bool)


def _topk_select(cols: list[np.ndarray], k: int) -> np.ndarray:
    """Positions of the k smallest rows under lexicographic (cols[0], cols[1], ...).

    Exact (tie-correct) partial selection: argpartition on the primary key,
    keep everything strictly below the cutoff, recurse into the cutoff's tie
    set on the remaining keys.  With a unique final key (file ids) the
    recursion is finite.  Returns UNORDERED positions — the caller sorts the
    (<= k)-row survivor set; at 1M files / 700k hits this replaces a full
    3-key lexsort (the measured host floor) with O(n) partitions.
    """
    n = len(cols[0])
    if k >= n or not cols:
        return np.arange(n)
    sel = _topk_select_inner(cols, k)
    if len(sel) < k:
        # any NaN manifestation (NaN cutoff empties strict AND tied, NaN rows
        # vanish from both sides of the partition) shows up as a short result
        # — take the exact full-sort path rather than silently truncating
        return np.arange(n)
    return sel


def _topk_select_inner(cols: list[np.ndarray], k: int) -> np.ndarray:
    n = len(cols[0])
    if k >= n:
        return np.arange(n)
    c0 = cols[0]
    cutoff = c0[np.argpartition(c0, k - 1)[:k]].max()
    if np.isnan(cutoff):
        return np.arange(n)
    strict = np.nonzero(c0 < cutoff)[0]
    need = k - len(strict)
    if need <= 0:
        # more strictly-below rows than k can only happen with NaNs; fall back
        return np.arange(n)
    tied = np.nonzero(c0 == cutoff)[0]
    if len(tied) <= need or len(cols) == 1:
        take = tied[:need] if len(cols) == 1 and len(tied) > need else tied
        return np.concatenate([strict, take])
    sub = _topk_select_inner([c[tied] for c in cols[1:]], need)
    return np.concatenate([strict, tied[sub]])


# Hit sets smaller than this sort fully — partitions only pay off at scale.
_TOPK_MIN_HITS = 16384


def search_epoch(
    epoch: TagIndexEpoch,
    query: str,
    *,
    thresholds: Mapping[int, float] | None = None,
    order_by: str = "relevance",
    limit: int = 200,
    offset: int = 0,
    mesh=None,  # parallel.mesh.Mesh: shard mask evaluation over its data axis
) -> list[DeviceSearchResult]:
    """Execute a query against the epoch; ordering parity with search_files."""
    if order_by not in _ORDERINGS:
        raise ValueError(f"order_by must be one of {_ORDERINGS}")
    expr = parse_query(query)
    thr = normalize_thresholds(thresholds or {})
    positive = (
        extract_positive_tag_terms(query) if order_by == "relevance" else []
    )
    mask = None
    if mesh is not None and int(mesh.shape.get("data", 1)) > 1:
        # multi-device: file-row-sharded mask evaluation (query/sharded);
        # relevance + ordering below are shared host code, so identity with
        # the single-device path is structural, not re-proved per feature
        from kobato_eyes_tpu_torch.query.sharded import sharded_mask_words

        # memoized unshardable verdict: a persistently unshardable
        # (epoch, mesh) pair must not re-attempt sharding and re-warn on
        # every query of a hot serving path. Keyed by epoch identity (weak)
        # holding the mesh ids ruled out for it; a recycled mesh id can at
        # worst serve single-device, never mis-answer.
        ruled_out = _UNSHARDABLE_VERDICTS.setdefault(epoch, set())
        if id(mesh) not in ruled_out:
            try:
                mask = _unpack_mask(
                    sharded_mask_words(epoch, mesh, query, expr, thr),
                    epoch.num_files,
                )
            except ValueError as exc:
                # e.g. a data axis that cannot divide the padded file rows:
                # serve the query on the epoch's device rather than failing
                logger.warning(
                    "mesh cannot shard this epoch (%s); single-device "
                    "(verdict cached for this epoch+mesh)", exc,
                )
                ruled_out.add(id(mesh))
    if mask is None:
        # mask evaluation on the device, then ONE copy of the packed words
        words = _mask_words(epoch, _slot_tables_np(epoch, expr, thr))
        mask = _unpack_mask(words.cpu().numpy(), epoch.num_files)
    return _rank_and_page(epoch, mask, positive, thr, order_by, limit, offset)


def _rank_and_page(
    epoch: TagIndexEpoch,
    mask: np.ndarray,
    positive: list[str],
    thr: dict[int, float],
    order_by: str,
    limit: int,
    offset: int,
) -> list[DeviceSearchResult]:
    """Shared host tail: relevance sum, ordering, paging, result assembly
    (identical for the single-chip, sharded, and batched mask paths)."""
    # relevance in host f64 — ordering must match SQLite's f64 SUM exactly.
    # One C-level bincount over the positives' postings (np.add.at per term
    # was the p50 floor at 300k files).
    rel = np.zeros(epoch.num_files, dtype=np.float64)
    if positive:
        row_parts: list[np.ndarray] = []
        sc_parts: list[np.ndarray] = []
        for name in positive:
            tid = epoch.name_to_tid.get(name)
            if tid is None:
                continue
            lo, hi = int(epoch.offsets[tid]), int(epoch.offsets[tid + 1])
            gate = _case_gate(thr, int(epoch.tag_cats[tid]))
            sc = epoch.scores_np[lo:hi]
            hit = sc >= gate
            row_parts.append(epoch.rows_np[lo:hi][hit])
            sc_parts.append(sc[hit])
        if row_parts:
            rel = np.bincount(
                np.concatenate(row_parts),
                weights=np.concatenate(sc_parts),
                minlength=epoch.num_files,
            )

    idx = np.nonzero(mask)[0]
    if idx.size == 0:
        return []
    k = offset + limit
    # large hit sets with a small page: exact partial top-k instead of a
    # full multi-key lexsort (the measured host floor at 1M files)
    partial_ok = (
        k > 0
        and idx.size > _TOPK_MIN_HITS
        and k * 4 < idx.size
    )
    if partial_ok:
        if order_by == "relevance":
            cols = [-rel[idx], -epoch.mtimes[idx], epoch.file_ids[idx]]
        elif order_by == "mtime":
            cols = [-epoch.mtimes[idx], epoch.file_ids[idx]]
        elif order_by == "path":
            cols = [epoch.path_ranks[idx], epoch.file_ids[idx]]
        else:
            cols = [epoch.file_ids[idx]]
        sel = _topk_select(cols, k)
        idx = idx[sel]
    if order_by == "relevance":
        order = np.lexsort((epoch.file_ids[idx], -epoch.mtimes[idx], -rel[idx].astype(np.float64)))
    elif order_by == "mtime":
        order = np.lexsort((epoch.file_ids[idx], -epoch.mtimes[idx]))
    elif order_by == "path":
        # integer ranks, order-isomorphic to the strings (see path_ranks)
        order = np.lexsort((epoch.file_ids[idx], epoch.path_ranks[idx]))
    else:
        order = np.argsort(epoch.file_ids[idx], kind="stable")
    chosen = idx[order][offset : offset + limit]
    return [
        DeviceSearchResult(
            file_id=int(epoch.file_ids[i]),
            path=epoch.paths[i],
            mtime=float(epoch.mtimes[i]),
            size=int(epoch.sizes[i]),
            relevance=float(rel[i]),
        )
        for i in chosen
    ]


def search_epoch_batch(
    epoch: TagIndexEpoch,
    queries: Sequence[str],
    *,
    thresholds: Mapping[int, float] | None = None,
    order_by: str = "relevance",
    limit: int = 200,
    offset: int = 0,
) -> list[list[DeviceSearchResult]]:
    """Execute many queries against the epoch with one device-to-host copy.

    Same results as ``[search_epoch(epoch, q, ...) for q in queries]`` — the
    mask evaluator and the host ranking tail are shared code — but every
    query's mask is enqueued before the batch waits ONCE for all the packed
    words, where each ``search_epoch`` waits for its own.
    """
    if order_by not in _ORDERINGS:
        raise ValueError(f"order_by must be one of {_ORDERINGS}")
    thr = normalize_thresholds(thresholds or {})

    positives: list[list[str]] = []
    pending: list[torch.Tensor] = []
    for query in queries:
        expr = parse_query(query)
        pending.append(_mask_words(epoch, _slot_tables_np(epoch, expr, thr)))
        positives.append(
            extract_positive_tag_terms(query) if order_by == "relevance" else []
        )
    if not pending:
        return []

    # ONE sync for every query's packed mask words
    fetched = torch.stack(pending).cpu().numpy()
    return [
        _rank_and_page(
            epoch, _unpack_mask(words, epoch.num_files), positive, thr, order_by, limit, offset
        )
        for words, positive in zip(fetched, positives)
    ]


# ---------------------------------------------------------------------------
# epoch manager (quiesce analog: build aside, swap atomically)
# ---------------------------------------------------------------------------


class EpochManager:
    """Holds the live epoch; rebuilds produce a new version then swap.
    Epochs are built on ``device`` (``None``: cuda)."""

    def __init__(self, device=None) -> None:
        self._device = resolve_device(device)
        self._epoch: TagIndexEpoch | None = None
        self._version = 0

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def current(self) -> TagIndexEpoch | None:
        return self._epoch

    def rebuild(self, conn: sqlite3.Connection) -> TagIndexEpoch:
        self._version += 1
        epoch = build_epoch(conn, version=self._version, device=self._device)
        self._epoch = epoch  # atomic reference swap; old readers keep theirs
        return epoch

    def apply_delta(
        self, conn: sqlite3.Connection, changed_file_ids: Sequence[int]
    ) -> TagIndexEpoch:
        """Incremental swap; falls back to a full rebuild when no epoch exists."""
        if self._epoch is None:
            return self.rebuild(conn)
        if not changed_file_ids:
            return self._epoch
        self._version += 1
        epoch = update_epoch(
            conn, self._epoch, changed_file_ids=changed_file_ids, version=self._version,
            device=self._device,
        )
        self._epoch = epoch
        return epoch
