"""Duplicate-engine data model.

Cluster identity rules (keeper choice, member ordering, cluster ordering,
extension priorities) replicate the reference exactly
(``src/dup/scanner.py:16-28,320-415``) because cluster *identity*, not just
similarity, is the acceptance criterion (SURVEY.md §7 hard parts).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import NamedTuple, Sequence

# Reference extension priority table (scanner.py:16-28): lossless > lossy.
EXTENSION_PRIORITY = {
    "png": 4,
    "apng": 4,
    "webp": 3,
    "tiff": 2,
    "tif": 2,
    "bmp": 1,
    "gif": 1,
    "jpeg": 0,
    "jpg": 0,
    "jpe": 0,
    "jfif": 0,
}


@dataclass(frozen=True)
class DuplicateFileMeta:
    """Metadata needed to cluster one file."""

    file_id: int
    path: Path
    size: int | None
    width: int | None
    height: int | None
    phash: int  # unsigned or signed 64-bit int
    embedding: tuple[float, ...] | None = None

    @property
    def resolution(self) -> int:
        return (self.width or 0) * (self.height or 0)

    @property
    def extension_priority(self) -> int:
        return EXTENSION_PRIORITY.get(self.path.suffix.lower().lstrip("."), 0)


class DuplicateClusterEntry(NamedTuple):
    # NamedTuple (not dataclass): constructed once per member on every scan;
    # tuple construction is ~7x cheaper and shows up at 70k-image scale.
    file: DuplicateFileMeta
    best_hamming: int | None


class DuplicateCluster(NamedTuple):
    # files is a TUPLE: clusters are immutable value objects, which lets the
    # engine's assembly memo share them across scans with a plain outer-list
    # copy — per-cluster defensive copies on the 70k hot path cost ~30 ms.
    files: tuple[DuplicateClusterEntry, ...]
    keeper_id: int


@dataclass(frozen=True)
class DuplicateScanConfig:
    """Candidate-generation thresholds (reference scanner.py:147-167)."""

    hamming_threshold: int = 8
    size_ratio: float | None = None
    band_bits: int = 16
    band_count: int = 4
    cosine_threshold: float | None = None
    bucket_pair_cap: int | None = None

    def __post_init__(self) -> None:
        if self.band_bits <= 0:
            raise ValueError("band_bits must be positive")
        if self.band_count <= 0:
            raise ValueError("band_count must be positive")
        if self.band_bits * self.band_count > 64:
            raise ValueError("band config too large")
        if not (0 <= self.hamming_threshold <= 64):
            raise ValueError("hamming_threshold must be in [0, 64]")
        if self.cosine_threshold is not None and not (-1.0 <= self.cosine_threshold <= 1.0):
            raise ValueError("cosine_threshold must be between -1.0 and 1.0")


def keeper_key(file: DuplicateFileMeta) -> tuple:
    """Keeper selection key (min wins); reference scanner.py:402-415."""
    return (
        -(file.size or 0),
        -file.resolution,
        -file.extension_priority,
        file.path.suffix.lower(),
        file.path.name.lower(),
        file.file_id,
    )


def entry_sort_key(entry: DuplicateClusterEntry, keeper_id: int) -> tuple:
    """Member ordering inside a cluster; reference scanner.py:338-349."""
    f = entry.file
    return (
        0 if f.file_id == keeper_id else 1,
        -(f.size or 0),
        -f.resolution,
        -f.extension_priority,
        f.path.name.lower(),
        f.file_id,
    )


def cluster_sort_key(cluster: DuplicateCluster) -> tuple:
    """Cluster ordering; reference scanner.py:350-356."""
    return (
        -max(entry.file.size or 0 for entry in cluster.files),
        cluster.files[0].file.path.as_posix().lower(),
    )


class NodeColumnCache:
    """Vectorized cross-scan cache of per-file sort-key columns.

    The assembly's per-node Python work (string keys, size/resolution
    extraction) is invariant across scans of the same library; this cache
    keeps the columns as numpy arrays keyed by a sorted file-id axis so a
    steady-state re-scan (or each threshold of a sweep) gathers them with
    searchsorted instead of 35k-iteration Python loops.  Hits are validated
    per row by meta-object IDENTITY (the cache holds strong refs, so an id()
    match proves the same live object), and misses are patched incrementally
    — a delta scan where a handful of files changed recomputes only those
    rows, which is what makes the warm non-memoized re-scan fast.

    String sort keys are cached as integer ranks into sorted unique-string
    axes (``*_u``): lexsorts stay integer-only, and a delta whose strings
    already exist ranks its new rows with one searchsorted.  Only genuinely
    new strings force a full re-rank of the affected column.
    """

    __slots__ = (
        "fids", "metas", "meta_ids", "sizes", "res", "extpri",
        "pathlow", "namelow", "suffix",
        "path_u", "name_u", "suffix_u", "path_r", "name_r", "suffix_r",
    )

    def __init__(self) -> None:
        import numpy as np

        self.fids = np.empty(0, dtype=np.int64)
        self.metas = np.empty(0, dtype=object)
        self.meta_ids = np.empty(0, dtype=np.uint64)
        self.sizes = np.empty(0, dtype=np.int64)
        self.res = np.empty(0, dtype=np.int64)
        self.extpri = np.empty(0, dtype=np.int64)
        self.pathlow = np.empty(0, dtype="U1")
        self.namelow = np.empty(0, dtype="U1")
        self.suffix = np.empty(0, dtype="U1")
        # sorted unique-string axes + per-row ranks into them (order-isomorphic)
        self.path_u = np.empty(0, dtype="U1")
        self.name_u = np.empty(0, dtype="U1")
        self.suffix_u = np.empty(0, dtype="U1")
        self.path_r = np.empty(0, dtype=np.int64)
        self.name_r = np.empty(0, dtype=np.int64)
        self.suffix_r = np.empty(0, dtype=np.int64)

    @staticmethod
    def _ids_of(metas) -> "np.ndarray":
        if isinstance(metas, list):
            from kobato_eyes_tpu_torch.native.build import object_ids_np

            return object_ids_np(metas)
        import numpy as np

        return np.fromiter(map(id, metas), dtype=np.uint64, count=len(metas))

    def lookup_partial(self, nodes, metas) -> tuple:
        """(gathered_cols | None, miss_positions).

        ``gathered_cols`` is non-None only on a FULL hit (every node present
        with identical meta objects); otherwise ``miss_positions`` lists the
        positions in ``nodes`` whose rows must be recomputed and fed to
        :meth:`store_delta`, after which :meth:`gather` returns the columns.
        """
        import numpy as np

        k = len(nodes)
        if len(self.fids) == 0 or k == 0:
            return None, np.arange(k, dtype=np.int64)
        pos = np.searchsorted(self.fids, nodes)
        # bound-check EVERY position: the public assembly entries make no
        # sortedness promise about nodes, so any element may search past the
        # cached axis, not just the last one
        inb = pos < len(self.fids)
        pos_c = np.where(inb, pos, 0)
        hit = inb & (self.fids[pos_c] == nodes)
        hit &= self.meta_ids[pos_c] == self._ids_of(metas)
        if hit.all():
            return (
                self.sizes[pos], self.res[pos], self.extpri[pos],
                self.path_r[pos], self.name_r[pos], self.suffix_r[pos],
            ), np.empty(0, dtype=np.int64)
        return None, np.flatnonzero(~hit)

    def gather(self, nodes) -> tuple:
        """Column gather for ``nodes`` (every node must be present)."""
        import numpy as np

        pos = np.searchsorted(self.fids, nodes)
        return (
            self.sizes[pos], self.res[pos], self.extpri[pos],
            self.path_r[pos], self.name_r[pos], self.suffix_r[pos],
        )

    _STRING_COLS = (
        ("pathlow", "path_u", "path_r"),
        ("namelow", "name_u", "name_r"),
        ("suffix", "suffix_u", "suffix_r"),
    )

    def _rerank(self, col: str) -> None:
        """Rebuild one string column's unique axis + all row ranks."""
        import numpy as np

        uniq_name, rank_name = next(
            (u, r) for c, u, r in self._STRING_COLS if c == col
        )
        uniq, ranks = np.unique(getattr(self, col), return_inverse=True)
        setattr(self, uniq_name, uniq)
        setattr(self, rank_name, ranks.astype(np.int64))

    def store_delta(self, nodes, metas, sizes, res, extpri, pathlow, namelow, suffix) -> None:
        """Merge recomputed rows into the cache (replace or insert by fid)."""
        import numpy as np

        metas_arr = np.empty(len(metas), dtype=object)
        metas_arr[:] = metas
        new_ids = self._ids_of(metas)
        cols_new = (metas_arr, new_ids, sizes.astype(np.int64), res.astype(np.int64),
                    extpri.astype(np.int64), np.asarray(pathlow),
                    np.asarray(namelow), np.asarray(suffix))
        col_names = ("metas", "meta_ids", "sizes", "res", "extpri",
                     "pathlow", "namelow", "suffix")
        if len(self.fids):
            pos = np.searchsorted(self.fids, nodes)
            inb = pos < len(self.fids)
            pos_c = np.where(inb, pos, 0)
            present = inb & (self.fids[pos_c] == nodes)
            if present.any():
                # in-place row replacement keeps the axis (and ranks) intact
                rows = pos[present]
                for name, new in zip(col_names, cols_new):
                    arr = getattr(self, name)
                    if name in ("pathlow", "namelow", "suffix"):
                        vals = new[present]
                        # numpy fixed-width strings: widen in-place target if needed
                        if vals.dtype.itemsize > arr.dtype.itemsize:
                            arr = arr.astype(vals.dtype)
                            setattr(self, name, arr)
                        arr[rows] = vals
                    else:
                        arr[rows] = new[present]
            if (~present).any():
                ins = ~present
                fids = np.concatenate([self.fids, nodes[ins]])
                order = np.argsort(fids, kind="stable")
                self.fids = fids[order]
                for name, new in zip(col_names, cols_new):
                    old = getattr(self, name)
                    merged = np.concatenate([old, new[ins]])
                    setattr(self, name, merged[order])
                # carry rank columns through the reorder with placeholders;
                # the rank-maintenance pass below fills the inserted rows
                n_ins = int(ins.sum())
                for _, _, rank_name in self._STRING_COLS:
                    ranks = getattr(self, rank_name)
                    merged = np.concatenate(
                        [ranks, np.full(n_ins, -1, dtype=np.int64)]
                    )
                    setattr(self, rank_name, merged[order])
        else:
            order = np.argsort(nodes, kind="stable")
            self.fids = nodes[order]
            for name, new in zip(col_names, cols_new):
                setattr(self, name, new[order])
            self.path_r = np.empty(len(nodes), dtype=np.int64)
            self.name_r = np.empty(len(nodes), dtype=np.int64)
            self.suffix_r = np.empty(len(nodes), dtype=np.int64)
            self._rerank("pathlow"); self._rerank("namelow"); self._rerank("suffix")
            return

        # rank maintenance: rows whose strings already exist rank with one
        # searchsorted; genuinely new strings force a column re-rank
        rows = np.searchsorted(self.fids, nodes)
        for col, uniq_name, rank_name in self._STRING_COLS:
            uniq = getattr(self, uniq_name)
            vals = getattr(self, col)[rows]
            if len(uniq):
                p = np.searchsorted(uniq, vals)
                known = uniq[np.minimum(p, len(uniq) - 1)] == vals
            else:
                known = np.zeros(len(vals), dtype=bool)
                p = np.zeros(len(vals), dtype=np.int64)
            if known.all():
                getattr(self, rank_name)[rows] = p
            else:
                self._rerank(col)


def _components_and_best_h(ia, ib, eh, k: int, m: int):
    """Connected components + per-node best (minimum) hamming, in node space."""
    import numpy as np
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    graph = coo_matrix((np.ones(m, dtype=np.int8), (ia, ib)), shape=(k, k))
    _, labels = connected_components(graph, directed=False)

    big = np.iinfo(np.int64).max
    best_h = np.full(k, big, dtype=np.int64)
    has_h = eh >= 0
    np.minimum.at(best_h, ia[has_h], eh[has_h])
    np.minimum.at(best_h, ib[has_h], eh[has_h])
    return labels, best_h, big


def assemble_clusters_indexed(
    files: Sequence[DuplicateFileMeta],
    ids: "np.ndarray",
    edges_idx: tuple["np.ndarray", "np.ndarray", "np.ndarray"],
    *,
    key_cache: dict[int, tuple[object, str, str, str, int]] | None = None,
    column_cache: NodeColumnCache | None = None,
) -> list[DuplicateCluster]:
    """Index-space assembly: edges are positions into ``files``/``ids``.

    Same result as :func:`assemble_clusters` (which is itself spec-tested
    against :func:`assemble_clusters_py`), without the 70k-entry
    id->meta dict and the int64 sort inside np.unique — node discovery is a
    boolean mask over the index space.  This is the engine's hot entry.
    """
    import numpy as np

    from kobato_eyes_tpu_torch.utils.metrics import metrics

    ei, ej, eh = edges_idx
    m = len(ei)
    if m == 0:
        return []

    _t_graph = metrics.timer("dup.assemble.graph"); _t_graph.__enter__()
    n = len(ids)
    present = np.zeros(n, dtype=bool)
    present[ei] = True
    present[ej] = True
    nodes_idx = np.flatnonzero(present)
    k = len(nodes_idx)
    remap = np.empty(n, dtype=np.int64)
    remap[nodes_idx] = np.arange(k, dtype=np.int64)
    ia, ib = remap[ei], remap[ej]
    nodes = ids[nodes_idx]
    eh = np.asarray(eh, dtype=np.int64)
    labels, best_h, big = _components_and_best_h(ia, ib, eh, k, m)
    _t_graph.__exit__(None, None, None)

    metas = [files[i] for i in nodes_idx.tolist()]
    return _assemble_tail(
        nodes, labels, best_h, big, metas, k,
        key_cache=key_cache, column_cache=column_cache,
    )


def assemble_clusters(
    files_by_id: dict[int, DuplicateFileMeta],
    edges: Sequence[tuple[int, int, int | None]],
    *,
    key_cache: dict[int, tuple[object, str, str, str, int]] | None = None,
    column_cache: NodeColumnCache | None = None,
) -> list[DuplicateCluster]:
    """Edges (file_id_a, file_id_b, hamming) -> ordered clusters (vectorized).

    Same result as :func:`assemble_clusters_py` (the executable spec, tested
    for equality) but with connected components, keeper choice, and ordering
    done as numpy/scipy array passes — at 70k images the per-edge Python DSU
    was the scan's dominant cost.
    """
    import numpy as np

    from kobato_eyes_tpu_torch.utils.metrics import metrics

    if isinstance(edges, tuple) and len(edges) == 3:
        # array fast path: (ids_a, ids_b, hamming) with -1 encoding "no dist"
        ea = np.asarray(edges[0], dtype=np.int64)
        eb = np.asarray(edges[1], dtype=np.int64)
        eh = np.asarray(edges[2], dtype=np.int64)
        m = len(ea)
    else:
        m = len(edges)
        ea = np.fromiter((e[0] for e in edges), dtype=np.int64, count=m)
        eb = np.fromiter((e[1] for e in edges), dtype=np.int64, count=m)
        eh = np.fromiter((-1 if e[2] is None else e[2] for e in edges), dtype=np.int64, count=m)
    if m == 0:
        return []

    _t_graph = metrics.timer("dup.assemble.graph"); _t_graph.__enter__()
    nodes, inverse = np.unique(np.concatenate([ea, eb]), return_inverse=True)
    ia, ib = inverse[:m], inverse[m:]
    k = len(nodes)

    labels, best_h, big = _components_and_best_h(ia, ib, eh, k, m)

    _t_graph.__exit__(None, None, None)
    metas = list(map(files_by_id.get, nodes.tolist()))
    if None in metas:
        present = np.array([mt is not None for mt in metas])
        idx = np.nonzero(present)[0]
        nodes, labels, best_h = nodes[idx], labels[idx], best_h[idx]
        metas = [metas[i] for i in idx]
        k = len(nodes)
    if k == 0:
        return []
    return _assemble_tail(
        nodes, labels, best_h, big, metas, k,
        key_cache=key_cache, column_cache=column_cache,
    )


def _assemble_tail(
    nodes: "np.ndarray",
    labels: "np.ndarray",
    best_h: "np.ndarray",
    big: int,
    metas: list[DuplicateFileMeta],
    k: int,
    *,
    key_cache: dict[int, tuple[object, str, str, str, int]] | None,
    column_cache: NodeColumnCache | None,
) -> list[DuplicateCluster]:
    """Columns -> ordering -> object burst (shared by both entry points)."""
    import numpy as np

    from kobato_eyes_tpu_torch.utils.metrics import metrics

    _t_cols = metrics.timer("dup.assemble.columns"); _t_cols.__enter__()
    cols = None
    miss_idx = None
    if column_cache is not None:
        cols, miss_idx = column_cache.lookup_partial(nodes, metas)
    if cols is not None:
        sizes, res, extpri, path_r, name_r, suffix_r = cols
    else:
        # rows to (re)compute: everything without a cache, only the identity
        # misses with one (the delta-scan case: a handful of changed files)
        sub = list(range(k)) if miss_idx is None else miss_idx.tolist()
        metas_sub = metas if miss_idx is None else [metas[i] for i in sub]
        ks = len(metas_sub)
        sizes = np.fromiter(((mt.size or 0) for mt in metas_sub), dtype=np.int64, count=ks)
        res = np.fromiter((mt.resolution for mt in metas_sub), dtype=np.int64, count=ks)
        # string keys in one Python pass (measurably faster than np.char at
        # 70k; Path property calls per key were the original hotspot)
        pathlow_l: list[str] = []
        namelow_l: list[str] = []
        suffix_l: list[str] = []
        extpri_np = np.zeros(ks, dtype=np.int64)
        for i, mt in enumerate(metas_sub):
            fid = mt.file_id
            cached = key_cache.get(fid) if key_cache is not None else None
            # identity hit first: service re-scans pass the same meta objects,
            # and `is` skips two str(Path) calls per node (measurable at 70k)
            if cached is not None and (cached[0] is mt.path or str(cached[0]) == str(mt.path)):
                _, p, name, sfx, pri = cached
            else:
                # pathlib-name semantics: split only on '/' (a backslash is a
                # legal POSIX filename character and stays part of the name key)
                p = str(mt.path).lower()
                name = p.rsplit("/", 1)[-1]
                stem, dot, ext = name.rpartition(".")
                # pathlib suffix semantics: '' for dotfiles ('.hidden') AND for
                # trailing dots ('name.')
                sfx = ("." + ext) if (stem and ext) else ""
                pri = EXTENSION_PRIORITY.get(ext, 0) if sfx else 0
                if key_cache is not None:
                    key_cache[fid] = (mt.path, p, name, sfx, pri)
            pathlow_l.append(p)
            namelow_l.append(name)
            suffix_l.append(sfx)
            extpri_np[i] = pri
        pathlow = np.array(pathlow_l)
        namelow = np.array(namelow_l)
        suffix = np.array(suffix_l)
        extpri = extpri_np
        # rank the strings once; every lexsort below is then integer-only
        if column_cache is not None:
            column_cache.store_delta(
                nodes if miss_idx is None else nodes[miss_idx],
                metas_sub, sizes, res, extpri, pathlow, namelow, suffix,
            )
            sizes, res, extpri, path_r, name_r, suffix_r = column_cache.gather(nodes)
        else:
            path_r = np.unique(pathlow, return_inverse=True)[1]
            name_r = np.unique(namelow, return_inverse=True)[1]
            suffix_r = np.unique(suffix, return_inverse=True)[1]

    _t_cols.__exit__(None, None, None)
    _t_sort = metrics.timer("dup.assemble.sort"); _t_sort.__enter__()
    # drop singleton components (reference: clusters need >= 2 members)
    counts = np.bincount(labels, minlength=labels.max() + 1)
    keep = counts[labels] >= 2
    if not keep.all():
        idx = np.nonzero(keep)[0]
        nodes, labels, best_h = nodes[idx], labels[idx], best_h[idx]
        metas = [metas[i] for i in idx]
        sizes, res, extpri = sizes[idx], res[idx], extpri[idx]
        suffix_r, name_r, path_r = suffix_r[idx], name_r[idx], path_r[idx]
        k = len(nodes)
    if k == 0:
        return []

    # --- ordering.  The sort keys share a common (-size, -res, -extpri)
    # prefix, so that triple is ranked ONCE (one 3-key lexsort + cumsum);
    # keeper/entry/cluster orders then pack (label, rank, ...) into single
    # uint64 keys and each becomes ONE stable argsort instead of a 7-key
    # lexsort (7 stable passes).  Stable ties resolve to row order, which is
    # ascending node id by construction — exactly the trailing `nodes` key.
    b_sz = max(int(sizes.max()).bit_length(), 1) if k else 1
    b_res = max(int(res.max()).bit_length(), 1) if k else 1
    b_ext = max(int(extpri.max()).bit_length(), 1) if k else 1
    if b_sz + b_res + b_ext <= 64:
        # one unstable u64 argsort (numpy radix) — ties share a rank, so
        # stability is irrelevant for ranking; ~ flipped bits give descending
        packed3 = (
            (sizes.astype(np.uint64) << np.uint64(b_res + b_ext))
            | (res.astype(np.uint64) << np.uint64(b_ext))
            | extpri.astype(np.uint64)
        )
        order3 = np.argsort(~packed3)
    else:  # >64-bit triple: exact 3-key lexsort fallback
        order3 = np.lexsort((-extpri, -res, -sizes))
    s_o, r_o, e_o = sizes[order3], res[order3], extpri[order3]
    neq3 = np.empty(k, dtype=bool)
    neq3[0] = False
    neq3[1:] = (s_o[1:] != s_o[:-1]) | (r_o[1:] != r_o[:-1]) | (e_o[1:] != e_o[:-1])
    sr_sorted = np.cumsum(neq3)
    sr_r = np.empty(k, dtype=np.uint64)
    sr_r[order3] = sr_sorted.astype(np.uint64)
    # size-only descending rank (cluster key = -max member size), same pass
    neq_s = np.empty(k, dtype=bool)
    neq_s[0] = False
    neq_s[1:] = s_o[1:] != s_o[:-1]
    szd_sorted = np.cumsum(neq_s)
    szd_r = np.empty(k, dtype=np.int64)
    szd_r[order3] = szd_sorted

    n_labels_total = int(labels.max()) + 1
    lab_u = labels.astype(np.uint64)
    b_lab = max(int(n_labels_total - 1).bit_length(), 1)
    b_sr = max(int(sr_sorted[-1]).bit_length(), 1)
    b_suf = max(int(suffix_r.max()).bit_length(), 1)
    b_name = max(int(name_r.max()).bit_length(), 1)
    b_path = max(int(path_r.max()).bit_length(), 1)
    b_idx = max(int(k - 1).bit_length(), 1)
    idx_u = np.arange(k, dtype=np.uint64)
    idx_mask = np.uint64((1 << b_idx) - 1)

    def _packed_order(key: "np.ndarray", key_bits: int) -> "np.ndarray":
        """Stable order of a packed uint64 key: row index rides the low bits
        so numpy's default (unstable, ~4x faster) sort IS the stable order,
        and the sorted values' low bits are the permutation directly."""
        if key_bits + b_idx <= 64:
            packed = (key << np.uint64(b_idx)) | idx_u
            return (np.sort(packed) & idx_mask).astype(np.int64)
        return np.argsort(key, kind="stable")

    if b_lab + b_sr + b_suf + b_name <= 64 and b_lab + 1 + b_sr + b_name <= 64:
        # keeper per cluster: single packed-key sort by keeper_key within label
        kkey = (
            (lab_u << np.uint64(b_sr + b_suf + b_name))
            | (sr_r << np.uint64(b_suf + b_name))
            | (suffix_r.astype(np.uint64) << np.uint64(b_name))
            | name_r.astype(np.uint64)
        )
        keeper_order = _packed_order(kkey, b_lab + b_sr + b_suf + b_name)
    else:  # pathological rank widths: exact 7-key lexsort fallback
        keeper_order = np.lexsort(
            (nodes, name_r, suffix_r, -extpri, -res, -sizes, labels)
        )
    first_of_label = np.ones(k, dtype=bool)
    sorted_labels = labels[keeper_order]
    first_of_label[1:] = sorted_labels[1:] != sorted_labels[:-1]
    keeper_rows = keeper_order[first_of_label]
    keeper_node_by_label = np.zeros(n_labels_total, dtype=np.int64)
    keeper_node_by_label[labels[keeper_rows]] = nodes[keeper_rows]
    is_keeper = nodes == keeper_node_by_label[labels]

    # member ordering within clusters (entry_sort_key)
    if b_lab + b_sr + b_suf + b_name <= 64 and b_lab + 1 + b_sr + b_name <= 64:
        ekey = (
            (lab_u << np.uint64(1 + b_sr + b_name))
            | ((~is_keeper).astype(np.uint64) << np.uint64(b_sr + b_name))
            | (sr_r << np.uint64(b_name))
            | name_r.astype(np.uint64)
        )
        entry_order = _packed_order(ekey, b_lab + 1 + b_sr + b_name)
    else:
        entry_order = np.lexsort(
            (nodes, name_r, -extpri, -res, -sizes, ~is_keeper, labels)
        )
    ordered_labels = labels[entry_order]
    boundaries = np.nonzero(np.diff(ordered_labels))[0] + 1
    starts = np.concatenate([[0], boundaries])
    ends = np.concatenate([boundaries, [k]])

    # per-label max size -> min descending size-rank (cluster ordering key).
    # keeper_order's first-of-label row already has the label's max size
    # (size is the keeper key's primary field), so no reduction is needed.
    big_rank = np.int64(k)
    minrank_by_label = np.full(n_labels_total, big_rank, dtype=np.int64)
    minrank_by_label[labels[keeper_rows]] = szd_r[keeper_rows]

    # cluster ordering decided on arrays BEFORE any objects exist
    # (cluster_sort_key = (-max member size, keeper path)), then objects are
    # built directly in final order with C-level map/zip passes
    first_rows = entry_order[starts]
    n_clusters = len(first_rows)
    b_rank = max(int(big_rank).bit_length(), 1)
    b_cidx = max(int(n_clusters - 1).bit_length(), 1)
    if b_rank + b_path + b_cidx <= 64:
        ckey = (
            minrank_by_label[labels[first_rows]].astype(np.uint64)
            << np.uint64(b_path + b_cidx)
        ) | (path_r[first_rows].astype(np.uint64) << np.uint64(b_cidx)) | np.arange(
            n_clusters, dtype=np.uint64
        )
        c_order = (np.sort(ckey) & np.uint64((1 << b_cidx) - 1)).astype(np.int64)
    elif b_rank + b_path <= 64:
        ckey = (
            minrank_by_label[labels[first_rows]].astype(np.uint64)
            << np.uint64(b_path)
        ) | path_r[first_rows].astype(np.uint64)
        c_order = np.argsort(ckey, kind="stable")
    else:
        maxsz_by_label = np.zeros(n_labels_total, dtype=np.int64)
        np.maximum.at(maxsz_by_label, labels, sizes)
        c_order = np.lexsort((path_r[first_rows], -maxsz_by_label[labels[first_rows]]))

    _t_sort.__exit__(None, None, None)
    _t_build = metrics.timer("dup.assemble.build"); _t_build.__enter__()
    # The build allocates ~2 objects per cluster member; generational GC
    # triggered mid-burst rescans the whole (large) meta population several
    # times.  Pause collection for the burst — measurably faster at 70k.
    import gc

    _gc_was_enabled = gc.isenabled()
    if _gc_was_enabled:
        gc.disable()
    try:
        keeper_ids = np.ascontiguousarray(nodes[first_rows][c_order], dtype=np.int64)
        starts_o = np.ascontiguousarray(starts[c_order], dtype=np.int64)
        ends_o = np.ascontiguousarray(ends[c_order], dtype=np.int64)
        out = None
        try:
            # native object-construction burst (~5x the bytecode loop at 70k)
            from kobato_eyes_tpu_torch.native.build import load_extension_module

            _assembly = load_extension_module("assembly")
            out = _assembly.build_clusters(
                DuplicateClusterEntry, DuplicateCluster, metas,
                np.ascontiguousarray(np.where(best_h == big, np.int64(-1), best_h)),
                np.ascontiguousarray(entry_order, dtype=np.int64),
                starts_o, ends_o, keeper_ids,
            )
        except Exception:  # toolchain-less host: keep the pure-Python burst
            logger_build = __import__("logging").getLogger(__name__)
            logger_build.debug("native assembly unavailable; python fallback", exc_info=True)
        if out is None:
            hamm_arr = best_h.astype(object)  # object ints in one C pass
            hamm_arr[best_h == big] = None
            metas_arr = np.empty(k, dtype=object)
            metas_arr[:] = metas
            # tuple so the slice below yields the cluster's immutable tuple
            # of entries directly (no per-cluster list->tuple pass)
            entries_all = tuple(map(
                DuplicateClusterEntry,
                metas_arr[entry_order].tolist(),
                hamm_arr[entry_order].tolist(),
            ))
            groups = map(
                entries_all.__getitem__,
                map(slice, starts_o.tolist(), ends_o.tolist()),
            )
            out = list(map(DuplicateCluster, groups, keeper_ids.tolist()))
    finally:
        # a MemoryError mid-burst must not leave collection off process-wide
        if _gc_was_enabled:
            gc.enable()
        _t_build.__exit__(None, None, None)
    return out


def assemble_clusters_py(
    files_by_id: dict[int, DuplicateFileMeta],
    edges: Sequence[tuple[int, int, int | None]],
) -> list[DuplicateCluster]:
    """Reference-shaped assembly (executable spec for the vectorized version).

    Implements the reference's DSU + assembly semantics exactly
    (scanner.py:304-356): union all edges, track per-file best (minimum)
    hamming, group by root, drop singletons, order members and clusters.
    """
    from kobato_eyes_tpu_torch.dup.dsu import DisjointSet

    dsu = DisjointSet()
    best_hamming: dict[int, int] = {}
    touched: set[int] = set()
    for a, b, h in edges:
        dsu.union(a, b)
        touched.add(a)
        touched.add(b)
        if h is not None:
            for fid in (a, b):
                cur = best_hamming.get(fid)
                if cur is None or h < cur:
                    best_hamming[fid] = h

    groups: dict[int, list[int]] = {}
    for fid in touched:
        groups.setdefault(dsu.find(fid), []).append(fid)

    clusters: list[DuplicateCluster] = []
    for members in groups.values():
        if len(members) < 2:
            continue
        entries = [
            DuplicateClusterEntry(file=files_by_id[fid], best_hamming=best_hamming.get(fid))
            for fid in sorted(members)
            if fid in files_by_id
        ]
        if len(entries) < 2:
            continue
        keeper_id = min(entries, key=lambda e: keeper_key(e.file)).file.file_id
        entries.sort(key=lambda e: entry_sort_key(e, keeper_id))
        clusters.append(DuplicateCluster(files=tuple(entries), keeper_id=keeper_id))

    clusters.sort(key=cluster_sort_key)
    return clusters
