"""Epoch snapshot/restore: persist device index epochs to disk.

The checkpoint story (SURVEY.md §5 checkpoint/resume): the catalog is the
durable source of truth, but a saved epoch lets a service come back up
without replaying the full build — restore, then apply deltas.  Format:
one ``.npz`` of arrays + a JSON sidecar of names/metadata, the same pair
``kobato_eyes_tpu/query/snapshot.py`` writes: a snapshot saved by either
package loads in the other.  ``load_epoch`` places the epoch on ``device``
(``None``: cuda).
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np

from kobato_eyes_tpu_torch.device import resolve_device
from kobato_eyes_tpu_torch.query.engine import TagIndexEpoch

# v2 adds a sha256 content digest to the sidecar: the sidecar/npz pair is
# swapped with two renames, and count-based checks alone cannot catch a crash
# between them when a delta preserved every count (e.g. a pure path rename).
_FORMAT_VERSION = 2
_ACCEPTED_FORMATS = {1, 2}


def _content_digest(
    file_ids: np.ndarray, offsets: np.ndarray, rows: np.ndarray, scores64: np.ndarray
) -> str:
    h = hashlib.sha256()
    for arr in (file_ids, offsets, rows, scores64):
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def save_epoch(epoch: TagIndexEpoch, path: str | Path) -> Path:
    """Write the epoch to ``path`` (.npz + .json sidecar). Returns the npz path."""
    base = Path(path)
    if base.suffix != ".npz":
        base = base.with_suffix(".npz")
    base.parent.mkdir(parents=True, exist_ok=True)
    tmp_npz = base.with_suffix(".tmp.npz")
    np.savez_compressed(
        tmp_npz,
        file_ids=epoch.file_ids,
        mtimes=epoch.mtimes,
        sizes=epoch.sizes,
        tag_cats=epoch.tag_cats,
        offsets=epoch.offsets,
        rows=epoch.rows_np,
        scores64=epoch.scores_np,  # f64 host copy (exact relevance ordering)
        cat_max=epoch.cat_max_dev[: epoch.num_files].cpu().numpy(),
        cat_present=epoch.cat_present_dev[: epoch.num_files].cpu().numpy(),
        smax=epoch.smax_dev[: epoch.num_files].cpu().numpy(),
        smin=epoch.smin_dev[: epoch.num_files].cpu().numpy(),
    )
    # atomic pair swap: sidecar first, then the npz (the loader treats a
    # mismatched pair as unusable via the consistency checks below)
    sidecar = base.with_suffix(".json")
    tmp_json = base.with_suffix(".tmp.json")
    tmp_json.write_text(
        json.dumps(
            {
                "format": _FORMAT_VERSION,
                "version": epoch.version,
                "built_at": epoch.built_at,
                "num_files": epoch.num_files,
                "nnz": int(len(epoch.rows_np)),
                "digest": _content_digest(
                    epoch.file_ids, epoch.offsets, epoch.rows_np, epoch.scores_np
                ),
                "paths": epoch.paths,
                "tag_names": epoch.tag_names,
            }
        ),
        encoding="utf-8",
    )
    tmp_json.replace(sidecar)
    tmp_npz.replace(base)
    return base


def load_epoch(path: str | Path, *, device=None) -> TagIndexEpoch:
    device = resolve_device(device)
    base = Path(path)
    if base.suffix != ".npz":
        base = base.with_suffix(".npz")
    meta = json.loads(base.with_suffix(".json").read_text(encoding="utf-8"))
    if meta.get("format") not in _ACCEPTED_FORMATS:
        raise ValueError(f"unsupported epoch snapshot format: {meta.get('format')}")
    arrays = np.load(base)
    tag_names = list(meta["tag_names"])
    scores64 = arrays["scores64"]
    # pair-consistency: a crash between the two renames (or manual tampering)
    # must not assemble a corrupt epoch from mismatched halves
    if len(meta["paths"]) != len(arrays["file_ids"]) or len(tag_names) + 1 != len(
        arrays["offsets"]
    ) or meta.get("nnz", len(scores64)) != len(scores64):
        raise ValueError("epoch snapshot sidecar/arrays mismatch")
    digest = meta.get("digest")
    if digest is not None and digest != _content_digest(
        arrays["file_ids"], arrays["offsets"], arrays["rows"], scores64
    ):
        raise ValueError("epoch snapshot content digest mismatch")
    from kobato_eyes_tpu_torch.query.engine import (
        _device_postings,
        _pad_extrema,
        _pad_panels,
        _to_device,
    )

    offsets = arrays["offsets"]
    rows = arrays["rows"]
    n = len(arrays["file_ids"])
    t_count = len(tag_names)
    t_idx = np.repeat(np.arange(t_count, dtype=np.int64), np.diff(offsets))
    n_pad, t_pad, rows_dev, scores_dev = _device_postings(
        rows.astype(np.int32), scores64.astype(np.float32), t_idx, n, t_count, device
    )
    cat_max_dev, cat_present_dev = _pad_panels(
        _to_device(arrays["cat_max"][:n], device), _to_device(arrays["cat_present"][:n], device),
        n_pad,
    )
    if "smax" in arrays.files:
        smax = arrays["smax"][:n]
        smin = arrays["smin"][:n]
    else:
        # pre-extrema snapshots: rebuild from the host CSR (one load-time pass)
        smax = np.full(n, -np.inf, dtype=np.float32)
        smin = np.full(n, np.inf, dtype=np.float32)
        if len(rows):
            sc32 = scores64.astype(np.float32)
            np.maximum.at(smax, rows, sc32)
            np.minimum.at(smin, rows, sc32)
    smax_dev, smin_dev = _pad_extrema(_to_device(smax, device), _to_device(smin, device), n_pad)
    return TagIndexEpoch(
        version=int(meta["version"]),
        file_ids=arrays["file_ids"],
        mtimes=arrays["mtimes"],
        sizes=(
            arrays["sizes"]
            if "sizes" in arrays.files
            else np.zeros(len(arrays["file_ids"]), np.int64)  # pre-sizes snapshots
        ),
        paths=list(meta["paths"]),
        tag_names=tag_names,
        tag_cats=arrays["tag_cats"],
        name_to_tid={n: i for i, n in enumerate(tag_names)},
        offsets=offsets,
        rows_dev=rows_dev,
        scores_dev=scores_dev,
        rows_np=rows,
        scores_np=scores64,
        cat_max_dev=cat_max_dev,
        cat_present_dev=cat_present_dev,
        smax_dev=smax_dev,
        smin_dev=smin_dev,
        n_pad=n_pad,
        t_pad=t_pad,
        built_at=float(meta["built_at"]),
    )
