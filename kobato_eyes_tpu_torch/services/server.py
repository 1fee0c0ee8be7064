"""HTTP serving mode: the resident-epoch query path behind a JSON API.

Counterpart of ``kobato_eyes_tpu/services/server.py``, with the same routes,
payloads and locks. The reference surfaces search/autocomplete/stats through
a desktop UI (``src/ui/tags_*``); this engine is headless-first and
production-serving is the analog surface: a long-lived process holds the
epoch on ``device`` (default ``cuda``; raises without a GPU), and epoch swaps
are atomic reference swaps (readers in flight keep the version they started
with and its tensors alive through their references — the quiesce story at
serving time). Every device object the server makes (the epoch manager, the
dup scanners and audit, the refine passes, the /similar index) is handed the
server's device explicitly, since each request runs on its own thread; all of
them enqueue on that device's one default stream.

Stdlib HTTP plumbing (ThreadingHTTPServer).  Endpoints:

- ``GET /healthz``              → liveness + epoch version/shape
- ``GET /search?q=…&order=…&limit=…&offset=…``
- ``GET /complete?prefix=…&limit=…``
- ``GET /stats?like=…&category=…&limit=…``
- ``GET /dup?hamming=…&size_ratio=…&limit=…&audit=1&refine=1`` → duplicate
  clusters (+ cohesion audit; refine verifies the returned window with the
  configured tile-hash + pixel-MAE passes) — the reference dup-tab workflow
- ``GET /file?id=…``            → catalog row + hydrated tags
- ``GET /thumb?id=…&size=…``    → cached WEBP thumbnail bytes
- ``GET /similar?id=…&k=…``     → find-similar over stored embeddings
- ``POST /trash`` (JSON ``{"file_ids": [...]}``) → reversible soft delete
- ``POST /reload``              → full epoch rebuild + threshold reload
- ``POST /delta`` (JSON ``{"changed_file_ids": [...]}``) → incremental swap

Catalog reads (stats/complete) share ONE lock-guarded SQLite connection
(ThreadingHTTPServer runs a thread per request, so per-thread connections
would leak a handle per request); the device query path never takes that
lock.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any
from urllib.parse import parse_qs, urlparse

from kobato_eyes_tpu_torch.db.connection import bootstrap
from kobato_eyes_tpu_torch.db.repository import autocomplete_tags, load_tag_thresholds, tag_stats
from kobato_eyes_tpu_torch.device import resolve_device
from kobato_eyes_tpu_torch.query.engine import (
    EpochManager,
    search_epoch,
    search_epoch_batch,
)

logger = logging.getLogger(__name__)


class NotFound(KeyError):
    """Entity lookup miss -> HTTP 404 (scoped: internal KeyErrors stay 500)."""

    def __str__(self) -> str:  # KeyError quotes its arg; we want the message
        return self.args[0] if self.args else "not found"


class QueryServer:
    """Owns the epoch manager + the shared catalog connection."""

    def __init__(
        self,
        db_path: str | Path,
        *,
        default_limit: int = 50,
        data_root: str | Path | None = None,
        refine_settings: Any | None = None,
        device=None,
    ) -> None:
        self._db_path = Path(db_path)
        self._device = resolve_device(device)
        # app-dir layout when serving a real data dir (trash is shared with
        # `ket dup --trash-duplicates`); next-to-the-db fallback otherwise
        self._data_root = Path(data_root) if data_root is not None else None
        # user-configured refine params (ket serve passes settings.refine so
        # /dup?refine=1 and `ket dup --refine` agree); schema defaults otherwise
        self._refine_settings = refine_settings
        self._manager = EpochManager(device=self._device)
        self._swap_lock = threading.Lock()  # one writer at a time
        # ONE shared catalog connection behind a lock: ThreadingHTTPServer
        # spawns a thread per request, so thread-local connections would
        # open (and leak until GC) one sqlite handle per request.  Catalog
        # reads are short; the device query path never takes this lock.
        self._conn_lock = threading.Lock()
        self._shared_conn = None
        self._thresholds: dict[int, float] = {}
        # dup scanners persist per config: device-resident hashes + snapshot
        # caches amortize across requests; one scan at a time (device-bound).
        # Bounded: each scanner holds device-resident copies of the whole
        # catalog's hashes (8 bytes a file and more), so a client sweeping
        # (hamming, size_ratio) must evict old configs, not accumulate them.
        self._dup_lock = threading.Lock()
        self._dup_scanners: dict[tuple, Any] = {}
        self._dup_scanners_cap = 4
        # catalog rows -> DuplicateFileMeta conversion cached per epoch
        # version: it is O(N) sqlite + object-build work that the engine's
        # files_token makes otherwise unread in the steady state
        self._dup_metas: tuple[int, list] | None = None
        # /similar: exact device index over the catalog's stored embeddings,
        # rebuilt lazily per epoch version (same invalidation as /dup metas)
        self._sim_lock = threading.Lock()
        self._sim_index: tuple | None = None
        # /thumb cache lives next to the catalog (reference keeps thumbnails
        # under the app cache dir; path+size+mtime keying is in image_io)
        base = self._data_root if self._data_root is not None else self._db_path.parent
        self._thumb_dir = base / "cache" / "thumbs" if self._data_root else base / "thumbs"
        self._trash_dir = base / "trash"
        self.started_at = time.time()

    def _conn(self):
        if self._shared_conn is None:
            self._shared_conn = bootstrap(self._db_path)
        return self._shared_conn

    # -- lifecycle ----------------------------------------------------------

    def warm(self) -> None:
        """Build the first epoch + load thresholds before serving."""
        with self._swap_lock, self._conn_lock:
            self._manager.rebuild(self._conn())
            self._thresholds = load_tag_thresholds(self._conn())

    def reload(self) -> dict[str, Any]:
        with self._swap_lock, self._conn_lock:
            epoch = self._manager.rebuild(self._conn())
            self._thresholds = load_tag_thresholds(self._conn())
        return {"epoch": epoch.version, "files": epoch.num_files, "tags": epoch.num_tags}

    def delta(self, changed_file_ids: list[int]) -> dict[str, Any]:
        with self._swap_lock, self._conn_lock:
            epoch = self._manager.apply_delta(self._conn(), changed_file_ids)
        return {"epoch": epoch.version, "files": epoch.num_files}

    # -- queries (lock-free: epoch reference is grabbed once per request) ----

    def health(self) -> dict[str, Any]:
        epoch = self._manager.current
        return {
            "ok": epoch is not None,
            "epoch": epoch.version if epoch else None,
            "files": epoch.num_files if epoch else 0,
            "tags": epoch.num_tags if epoch else 0,
            "uptime_s": round(time.time() - self.started_at, 1),
        }

    def search(self, q: str, *, order: str, limit: int, offset: int) -> dict[str, Any]:
        epoch = self._manager.current
        if epoch is None:
            raise RuntimeError("no epoch yet; POST /reload first")
        t0 = time.perf_counter()
        rows = search_epoch(
            epoch, q, thresholds=self._thresholds,
            order_by=order, limit=limit, offset=offset,
        )
        return {
            "epoch": epoch.version,
            "elapsed_ms": round((time.perf_counter() - t0) * 1e3, 2),
            "results": [
                {"file_id": r.file_id, "path": r.path, "relevance": r.relevance}
                for r in rows
            ],
        }

    def search_batch(
        self, queries: list[str], *, order: str, limit: int, offset: int
    ) -> dict[str, Any]:
        """Amortized multi-query search: every query's mask is enqueued and
        the batch waits for the device once (POST /search), where single
        queries wait once each."""
        epoch = self._manager.current
        if epoch is None:
            raise RuntimeError("no epoch yet; POST /reload first")
        t0 = time.perf_counter()
        batches = search_epoch_batch(
            epoch, queries, thresholds=self._thresholds,
            order_by=order, limit=limit, offset=offset,
        )
        return {
            "epoch": epoch.version,
            "elapsed_ms": round((time.perf_counter() - t0) * 1e3, 2),
            "batches": [
                {
                    "query": q,
                    "results": [
                        {"file_id": r.file_id, "path": r.path, "relevance": r.relevance}
                        for r in rows
                    ],
                }
                for q, rows in zip(queries, batches)
            ],
        }

    def dup(
        self,
        *,
        hamming: int = 8,
        size_ratio: float | None = None,
        limit: int = 100,
        audit: bool = False,
        refine: bool = False,
    ) -> dict[str, Any]:
        """Duplicate clusters from the catalog (reference dup-tab workflow).

        The scanner instance persists per config so its device-resident
        hashes and snapshot caches survive across requests; ``files_token``
        is the live epoch version, so an unchanged catalog reuses the
        scanner's prepared columns and assembly while any /reload or /delta
        naturally invalidates.
        """
        from kobato_eyes_tpu_torch.db.repository import iter_files_for_dup
        from kobato_eyes_tpu_torch.dup.engine import TpuDuplicateScanner
        from kobato_eyes_tpu_torch.dup.types import DuplicateFileMeta, DuplicateScanConfig

        if self._manager.current is None:
            raise RuntimeError("no epoch yet; POST /reload first")
        cfg = DuplicateScanConfig(
            hamming_threshold=int(hamming),
            size_ratio=float(size_ratio) if size_ratio is not None else None,
        )
        key = (cfg.hamming_threshold, cfg.size_ratio)
        with self._dup_lock:
            # read the epoch UNDER the lock: a /reload between an early read
            # and the lock would cache metas built from the NEW catalog under
            # the OLD version token (one response could mix the two)
            epoch = self._manager.current
            scanner = self._dup_scanners.pop(key, None)
            if scanner is None:
                while len(self._dup_scanners) >= self._dup_scanners_cap:
                    self._dup_scanners.pop(next(iter(self._dup_scanners)))
                scanner = TpuDuplicateScanner(cfg, device=self._device)
            self._dup_scanners[key] = scanner  # re-insert = LRU order
            cached = self._dup_metas
            if cached is not None and cached[0] == epoch.version:
                metas = cached[1]
            else:
                with self._conn_lock:
                    rows = iter_files_for_dup(self._conn())
                metas = [
                    DuplicateFileMeta(
                        file_id=int(r["id"]), path=Path(r["path"]), size=r["size"],
                        width=r["width"], height=r["height"], phash=r["phash_u64"],
                    )
                    for r in rows
                    if r["phash_u64"] is not None
                ]
                self._dup_metas = (epoch.version, metas)
            t0 = time.perf_counter()
            clusters = scanner.build_clusters(
                metas, files_token=("epoch", epoch.version, key)
            )
            lim = max(0, int(limit))
            shown = clusters[:lim]
            if refine and shown:
                # the reference auto-refines after every scan
                # (dup_tab.py:655-656, tile grid/tile/max_bits spins + the
                # pixel-MAE pass); settings mirror `ket dup --refine`.
                # Refinement decodes real images, so a request's IO work is
                # bounded: refine limit-sized chunks, refilling from later
                # clusters when verification empties the window, up to 4x
                # the limit — starvation needs most of the catalog to be
                # false positives, not just the first window.
                from kobato_eyes_tpu_torch.core.config.schema import RefineSettings
                from kobato_eyes_tpu_torch.dup.refine_clusters import (
                    refine_by_pixels,
                    refine_by_tilehash,
                )

                r = self._refine_settings or RefineSettings()
                survivors: list = []
                start = 0
                budget = 4 * max(1, lim)
                while start < len(clusters) and len(survivors) < lim and budget > 0:
                    chunk = clusters[start : start + lim]
                    start += len(chunk)
                    budget -= len(chunk)
                    chunk = refine_by_tilehash(
                        chunk, grid=r.grid, tile=r.tile, max_bits=r.max_bits,
                        device=self._device,
                    )
                    chunk = refine_by_pixels(
                        chunk, mae_thr=r.mae_threshold, thumb_size=r.mae_size,
                        device=self._device,
                    )
                    survivors.extend(chunk)
                shown = survivors[:lim]
            elapsed_ms = round((time.perf_counter() - t0) * 1e3, 2)
            out: dict[str, Any] = {
                "epoch": epoch.version,
                "elapsed_ms": elapsed_ms,
                "total_clusters": len(clusters),
                "refined_clusters": len(shown) if refine else None,
                "clusters": [
                    {
                        "keeper_id": c.keeper_id,
                        "members": [
                            {
                                "file_id": e.file.file_id,
                                "path": str(e.file.path),
                                "hamming": e.best_hamming,
                            }
                            for e in c.files
                        ],
                    }
                    for c in shown
                ],
            }
            if audit and shown:
                from kobato_eyes_tpu_torch.dup.audit import audit_clusters

                stats = audit_clusters(shown, device=self._device)
                out["audit"] = [
                    {
                        "keeper_id": s.keeper_id, "size": s.size,
                        "diameter": s.diameter,
                        "mean_distance": round(s.mean_distance, 3),
                        "keeper_max": s.keeper_max,
                    }
                    for s in stats
                ]
            return out

    def file_info(self, file_id: int) -> dict[str, Any]:
        """Catalog row + hydrated tags (the reference result views' payload:
        repository.py:373-389 hydration feeding the table/grid delegates)."""
        from kobato_eyes_tpu_torch.db.repository import get_file_by_id, tags_for_files

        with self._conn_lock:
            row = get_file_by_id(self._conn(), file_id)
            if row is None:
                raise NotFound(f"no file with id {file_id}")
            tags = tags_for_files(self._conn(), [file_id]).get(file_id, [])
        return {
            "file_id": int(row["id"]),
            "path": row["path"],
            "size": row["size"],
            "width": row["width"],
            "height": row["height"],
            "mtime": row["mtime"],
            "is_present": row["is_present"],
            "tags": [
                {"name": n, "score": round(float(s), 4), "category": int(c)}
                for n, s, c in tags
            ],
        }

    def thumbnail(self, file_id: int, *, size: int) -> Path | None:
        """Cached WEBP thumbnail for a catalog file (reference
        image_io.py:181-263 cache semantics: keyed by path+size+mtime)."""
        from kobato_eyes_tpu_torch.db.repository import get_file_by_id
        from kobato_eyes_tpu_torch.utils.image_io import generate_thumbnail

        with self._conn_lock:
            row = get_file_by_id(self._conn(), file_id)
        if row is None:
            raise NotFound(f"no file with id {file_id}")
        return generate_thumbnail(
            row["path"], cache_dir=self._thumb_dir, size=max(16, min(1024, size))
        )

    def trash(self, file_ids: list[int]) -> dict[str, Any]:
        """Move files to the app trash and soft-delete their rows (the
        reference dup-tab's "trash checked" action, dup_tab.py:816-836;
        reversible via utils.fs.restore_from_trash).  The live epoch keeps
        serving the old snapshot until /reload or /delta."""
        from kobato_eyes_tpu_torch.db.repository import get_file_by_id, mark_files_absent
        from kobato_eyes_tpu_torch.utils.fs import append_trash_record, trash_file

        # row lookups under the connection lock; the filesystem moves run
        # OUTSIDE it so a slow disk cannot stall every other catalog request
        with self._conn_lock:
            conn = self._conn()
            rows = {int(fid): get_file_by_id(conn, fid) for fid in file_ids}
        trashed: list[int] = []
        failed: list[int] = []
        for fid, row in rows.items():
            dest = None
            if row is not None:
                # per-file isolation: one unmovable file (permissions,
                # system-path guard) must not abort the batch and leave
                # earlier moves unrecorded in the catalog
                try:
                    dest = trash_file(row["path"], trash_dir=self._trash_dir)
                except (OSError, ValueError) as exc:
                    logger.warning("trash failed for %s: %s", row["path"], exc)
            if dest is None:
                failed.append(fid)
            else:
                append_trash_record(
                    self._trash_dir, file_id=fid,
                    original=row["path"], trashed=dest,
                )
                trashed.append(fid)
        if trashed:
            with self._conn_lock:
                mark_files_absent(self._conn(), trashed)
                self._conn().commit()
        return {"trashed": trashed, "failed": failed,
                "note": "POST /reload or /delta to refresh the serving epoch"}

    def similar(self, file_id: int, *, k: int) -> dict[str, Any]:
        """Find-similar ("more like this") over the catalog's stored
        embeddings — the activated ANN story (reference's dormant
        ``src/index``) served per file.  Exact cosine search: at catalog
        scale the full corpus matmul is the measured-fastest index."""
        from kobato_eyes_tpu_torch.core.pipeline.embed_stage import (
            load_embedding,
            load_embeddings,
        )
        from kobato_eyes_tpu_torch.index.flat import FlatIndex, find_similar

        epoch = self._manager.current
        if epoch is None:
            raise RuntimeError("no epoch yet; POST /reload first")
        with self._sim_lock:
            cached = self._sim_index
            if cached is None or cached[0] != epoch.version:
                with self._conn_lock:
                    ids, vecs = load_embeddings(self._conn())
                if len(ids) == 0:
                    raise NotFound(
                        "catalog has no embeddings; enable index settings and re-index"
                    )
                # only the device-resident index is retained — the query
                # vector comes from a per-request point query, so no host
                # copy of the corpus outlives the build
                cached = (epoch.version, FlatIndex(vecs, ids, device=self._device))
                self._sim_index = cached
            _, index = cached
        with self._conn_lock:
            qvec = load_embedding(self._conn(), file_id)
        if qvec is None:
            raise NotFound(f"no embedding for file {file_id}")
        k = max(1, min(100, k))
        neighbors = find_similar(index, qvec, exclude_id=file_id, k=k)
        with self._conn_lock:
            ph = ",".join("?" * len(neighbors)) or "NULL"
            rows = self._conn().execute(
                f"SELECT id, path FROM files WHERE id IN ({ph})",
                [fid for fid, _ in neighbors],
            ).fetchall()
        paths = {int(r["id"]): r["path"] for r in rows}
        return {
            "epoch": epoch.version,
            "query": int(file_id),
            "results": [
                {"file_id": fid, "path": paths.get(fid), "score": round(score, 4)}
                for fid, score in neighbors
            ],
        }

    def complete(self, prefix: str, *, limit: int) -> dict[str, Any]:
        with self._conn_lock:
            return {"completions": autocomplete_tags(self._conn(), prefix, limit=limit)}

    def stats(self, *, like: str | None, category: int | None, limit: int) -> dict[str, Any]:
        with self._conn_lock:
            rows = tag_stats(
                self._conn(), thresholds=self._thresholds,
                name_like=like, category=category, limit=limit,
            )
        return {"stats": [dict(r) for r in rows]}


# Largest accepted POST body (a /delta of ~1M changed ids is ~8 MB of JSON).
_MAX_POST_BYTES = 32 * 1024 * 1024


class _Handler(BaseHTTPRequestHandler):
    server_version = "ket-serve/1"
    core: QueryServer  # set via the server factory

    # Failure policy: a bad request or query error answers 4xx/5xx JSON and
    # never takes the process down (per-request isolation).
    def _reply(self, status: int, payload: dict[str, Any]) -> None:
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt: str, *args: Any) -> None:  # route to logging
        logger.debug("http %s", fmt % args)

    def do_GET(self) -> None:  # noqa: N802 — http.server API
        url = urlparse(self.path)
        qs = {k: v[0] for k, v in parse_qs(url.query).items()}
        try:
            if url.path == "/healthz":
                self._reply(200, self.core.health())
            elif url.path == "/search":
                self._reply(200, self.core.search(
                    qs.get("q", ""),
                    order=qs.get("order", "relevance"),
                    limit=int(qs.get("limit", 50)),
                    offset=int(qs.get("offset", 0)),
                ))
            elif url.path == "/complete":
                self._reply(200, self.core.complete(
                    qs.get("prefix", ""), limit=int(qs.get("limit", 20))
                ))
            elif url.path == "/stats":
                cat = qs.get("category")
                self._reply(200, self.core.stats(
                    like=qs.get("like"),
                    category=int(cat) if cat is not None else None,
                    limit=int(qs.get("limit", 100)),
                ))
            elif url.path == "/dup":
                sr = qs.get("size_ratio")
                self._reply(200, self.core.dup(
                    hamming=int(qs.get("hamming", 8)),
                    size_ratio=float(sr) if sr is not None else None,
                    limit=int(qs.get("limit", 100)),
                    audit=qs.get("audit", "0") not in ("0", "", "false"),
                    refine=qs.get("refine", "0") not in ("0", "", "false"),
                ))
            elif url.path == "/similar":
                if "id" not in qs:
                    raise ValueError("missing id parameter")
                self._reply(200, self.core.similar(
                    int(qs["id"]), k=int(qs.get("k", 12))
                ))
            elif url.path == "/file":
                if "id" not in qs:
                    raise ValueError("missing id parameter")
                self._reply(200, self.core.file_info(int(qs["id"])))
            elif url.path == "/thumb":
                if "id" not in qs:
                    raise ValueError("missing id parameter")
                thumb = self.core.thumbnail(
                    int(qs["id"]), size=int(qs.get("size", 256))
                )
                if thumb is None:
                    self._reply(404, {"error": "thumbnail unavailable"})
                else:
                    # read BEFORE the status line so IO errors still produce a
                    # clean 500; once headers are out, a write failure must NOT
                    # route through _reply (it would append a second status
                    # line onto the partially-written 200) — log + drop instead
                    body = thumb.read_bytes()
                    self.send_response(200)
                    self.send_header("Content-Type", "image/webp")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    try:
                        self.wfile.write(body)
                    except OSError:
                        logger.warning(
                            "thumb write aborted mid-response: %s", self.path
                        )
                        self.close_connection = True
            else:
                self._reply(404, {"error": "unknown endpoint"})
        except NotFound as exc:
            self._reply(404, {"error": str(exc)})
        except ValueError as exc:  # query parse errors and bad params
            self._reply(400, {"error": str(exc)})
        except Exception as exc:  # noqa: BLE001
            logger.exception("request failed: %s", self.path)
            self._reply(500, {"error": str(exc)})

    def do_POST(self) -> None:  # noqa: N802
        url = urlparse(self.path)
        try:
            if url.path == "/reload":
                self._reply(200, self.core.reload())
            elif url.path == "/search":
                length = int(self.headers.get("Content-Length", 0))
                if length > _MAX_POST_BYTES:
                    self._reply(413, {"error": "request body too large"})
                    return
                payload = json.loads(self.rfile.read(length) or b"{}")
                queries = payload.get("queries", [])
                if not isinstance(queries, list) or not queries or not all(
                    isinstance(q, str) for q in queries
                ):
                    raise ValueError("queries must be a non-empty string list")
                self._reply(200, self.core.search_batch(
                    queries,
                    order=payload.get("order", "relevance"),
                    limit=int(payload.get("limit", 50)),
                    offset=int(payload.get("offset", 0)),
                ))
            elif url.path == "/delta":
                length = int(self.headers.get("Content-Length", 0))
                if length > _MAX_POST_BYTES:
                    # bound request-body allocation: client-supplied
                    # Content-Length is read fully into memory below
                    self._reply(413, {"error": "request body too large"})
                    return
                payload = json.loads(self.rfile.read(length) or b"{}")
                ids = payload.get("changed_file_ids", [])
                if not isinstance(ids, list):
                    raise ValueError("changed_file_ids must be a list")
                self._reply(200, self.core.delta([int(i) for i in ids]))
            elif url.path == "/trash":
                length = int(self.headers.get("Content-Length", 0))
                if length > _MAX_POST_BYTES:
                    self._reply(413, {"error": "request body too large"})
                    return
                payload = json.loads(self.rfile.read(length) or b"{}")
                ids = payload.get("file_ids", [])
                if not isinstance(ids, list) or not ids:
                    raise ValueError("file_ids must be a non-empty list")
                self._reply(200, self.core.trash([int(i) for i in ids]))
            else:
                self._reply(404, {"error": "unknown endpoint"})
        except (ValueError, json.JSONDecodeError) as exc:
            self._reply(400, {"error": str(exc)})
        except Exception as exc:  # noqa: BLE001
            logger.exception("request failed: %s", self.path)
            self._reply(500, {"error": str(exc)})


def make_server(
    db_path: str | Path,
    host: str = "127.0.0.1",
    port: int = 0,
    *,
    warm: bool = True,
    data_root: str | Path | None = None,
    refine_settings: Any | None = None,
    device=None,
) -> tuple[ThreadingHTTPServer, QueryServer]:
    """Build (but don't run) the HTTP server; port 0 picks a free port. The
    epoch and every device pass live on ``device`` (default ``cuda``)."""
    core = QueryServer(db_path, data_root=data_root, refine_settings=refine_settings,
                       device=device)
    if warm:
        core.warm()
    handler = type("BoundHandler", (_Handler,), {"core": core})
    httpd = ThreadingHTTPServer((host, port), handler)
    return httpd, core


def serve_forever(
    db_path: str | Path, host: str, port: int,
    *, data_root: str | Path | None = None, refine_settings: Any | None = None,
    device=None,
) -> None:
    httpd, core = make_server(
        db_path, host, port, data_root=data_root, refine_settings=refine_settings,
        device=device,
    )
    health = core.health()
    logger.info(
        "serving on http://%s:%d  epoch v%s (%d files, %d tags)",
        *httpd.server_address, health["epoch"], health["files"], health["tags"],
    )
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
