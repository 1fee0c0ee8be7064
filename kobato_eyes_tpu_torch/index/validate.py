"""CLIP-embedder checkpoint validation (the index layer's lane of
``ket validate-checkpoint``).

Counterpart of ``kobato_eyes_tpu/index/validate.py``, with the same report
keys. It lives here, not in models/validate.py, because the lane's subjects
— the embedder and the exact-search sanity check — are index-layer
machinery (models must not import upward).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np
import torch

from kobato_eyes_tpu_torch.models.validate import _synthetic_batch


def validate_clip_checkpoint(
    path: str | Path,
    *,
    preset: str = "base",
    image_size: int = 224,
    patch_size: int = 32,
    embed_dim: int = 512,
    clip_variant: str = "openai",
    n_images: int = 8,
    device: str | torch.device | None = None,
) -> dict[str, Any]:
    """CLIP-embedder validation lane on ``device`` (default ``cuda``):
    import (strict manifest) -> embed a fixed probe set twice -> exact-search
    sanity (every probe retrieves itself first, no two probes collapse)."""
    from kobato_eyes_tpu_torch.index.embedder import ImageEmbedder
    from kobato_eyes_tpu_torch.index.flat import FlatIndex

    path = Path(path)
    report: dict[str, Any] = {
        "path": str(path), "arch": "clip", "preset": preset,
        "clip_variant": clip_variant, "embed_dim": embed_dim,
        "image_size": image_size,
    }
    emb = ImageEmbedder.from_clip_checkpoint(
        path, clip_variant=clip_variant, preset=preset,
        image_size=image_size, patch_size=patch_size, embed_dim=embed_dim, device=device,
    )
    # a checkpoint directory (``ket import-weights --arch clip``) is held to
    # its manifest; a weights file to the key/shape manifest
    report["import"] = "checkpoint" if path.is_dir() else "strict-manifest-ok"

    images = _synthetic_batch(image_size, n_images)
    vecs = emb.embed_batch(images)
    vecs2 = emb.embed_batch(images)
    finite = bool(np.isfinite(vecs).all())
    norms = np.linalg.norm(vecs, axis=1)
    unit_norm = bool(np.allclose(norms, 1.0, atol=1e-3)) if finite else False
    deterministic = bool(np.max(np.abs(vecs - vecs2)) <= 1e-5) if finite else False
    report["finite"] = finite
    report["unit_norm"] = unit_norm
    report["deterministic"] = deterministic

    # exact-search sanity: every probe retrieves itself at rank 1, and
    # distinct probes do not collapse onto one vector
    self_recall = 0.0
    collapse = 1.0
    if finite:
        index = FlatIndex(vecs, np.arange(len(vecs)), device=emb.device)
        _, ids = index.search(vecs, k=2)
        self_recall = float(np.mean(ids[:, 0] == np.arange(len(vecs))))
        sims = vecs @ vecs.T
        np.fill_diagonal(sims, -1.0)
        collapse = float(sims.max())
    report["self_recall_at_1"] = self_recall
    report["max_cross_similarity"] = round(collapse, 5)
    report["ok"] = bool(
        finite and unit_norm and deterministic
        and self_recall == 1.0 and collapse < 0.9999
    )
    return report
