"""Single-image tagging job: load -> infer -> persist -> signatures.

Counterpart of ``kobato_eyes_tpu/core/tag_job.py`` (the reference's per-image
path, ``src/core/tag_job.py:23-80``) used by the watcher pipeline: one file
in, catalog row + tags + perceptual signatures out. Batch-of-one on the
device — correct but not the throughput path; bulk runs go through the
pipeline stages.

The watcher calls it from its worker threads, and a thread starts on CUDA
device 0: the job makes the tagger's device current for its own work. The
signature hash runs on the tagger's device, or on ``device`` for a tagger
without one (the dummy), as the index pipeline's fused lane does.
"""

from __future__ import annotations

import contextlib
import logging
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from kobato_eyes_tpu_torch.core.pipeline.fingerprint import current_tagger_sig
from kobato_eyes_tpu_torch.db.connection import bootstrap
from kobato_eyes_tpu_torch.db.repository import TaggingItem, upsert_file, upsert_signatures, write_tagging_batch
from kobato_eyes_tpu_torch.device import resolve_device
from kobato_eyes_tpu_torch.models.base import ITagger
from kobato_eyes_tpu_torch.sig.signatures import hash_images
from kobato_eyes_tpu_torch.utils.bits import to_signed64, u32pair_to_u64
from kobato_eyes_tpu_torch.utils.hashing import compute_sha256
from kobato_eyes_tpu_torch.utils.image_io import safe_load_image

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class TagJobResult:
    file_id: int | None
    tagged: bool
    reason: str = ""


def _current(dev: torch.device):
    """Make ``dev`` the calling thread's current CUDA device (nothing on the CPU)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def run_tag_job(
    db_path: str | Path,
    tagger: ITagger,
    path: str | Path,
    *,
    compute_signature: bool = True,
    device=None,
) -> TagJobResult:
    """Tag one file end-to-end. Per-file failures return a result, never raise."""
    p = Path(path)
    img = safe_load_image(p)
    if img is None:
        return TagJobResult(file_id=None, tagged=False, reason="undecodable")
    import numpy as np

    arr = np.asarray(img, dtype=np.uint8)
    tagger_device = getattr(tagger, "device", None)
    dev = resolve_device(tagger_device if tagger_device is not None else device)
    with _current(dev):
        results = tagger.infer_batch([arr])
    sig = current_tagger_sig(tagger.signature_fields())

    try:
        st = p.stat()
        sha = compute_sha256(p)
    except OSError as exc:
        return TagJobResult(file_id=None, tagged=False, reason=f"stat/hash failed: {exc}")

    conn = bootstrap(db_path)
    try:
        fid = upsert_file(
            conn, path=p, size=st.st_size, mtime=st.st_mtime, sha256=sha,
            width=img.width, height=img.height,
        )
        write_tagging_batch(
            conn,
            [
                TaggingItem(
                    file_id=fid,
                    tags=[(t.name, t.score, int(t.category)) for t in results[0].tags],
                    width=img.width, height=img.height,
                    tagger_sig=sig, tagged_at=time.time(),
                )
            ],
        )
        if compute_signature:
            with _current(dev):
                ph, dh = hash_images([img], device=dev)
            with conn:
                upsert_signatures(
                    conn,
                    [(
                        fid,
                        to_signed64(int(u32pair_to_u64(ph)[0])),
                        to_signed64(int(u32pair_to_u64(dh)[0])),
                    )],
                )
        conn.commit()
    finally:
        conn.close()
    return TagJobResult(file_id=fid, tagged=True)
