"""One-shot checkpoint validation: import -> exact-vs-fast parity -> tag parity.

Counterpart of ``kobato_eyes_tpu/models/validate.py``, with the same lanes
and report keys. For a checkpoint file it answers what random weights
cannot:

1. **Import**: does the file convert under strict manifest validation
   (every drifted key named)?
2. **Numerics**: is the fast forward (the CUDA attention kernel plus
   tanh-gelu) finite on these weights, and how far do its probabilities
   deviate from the exact einsum/erf forward?
3. **Tags**: do any tags flip between the two forwards at the production
   thresholds?

Lanes: ``swinv2`` and ``vit`` (WD14 class) and ``pixai`` (ViT backbone,
preprocess.json discovery, ips propagation probe); the ``clip`` lane is
``index/validate.py``. Orbax directories come with the checkpoint IO slice
and ``.onnx`` files with the ONNX import slice. ``cli.cmd_validate_checkpoint``
is the thin shell.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

logger = logging.getLogger(__name__)

# Deviation above this between exact and fast probabilities fails validation
# (the JAX package's bound).
DEFAULT_PROB_TOLERANCE = 0.02


def _synthetic_batch(image_size: int, n: int, seed: int = 0) -> list[np.ndarray]:
    """Deterministic validation images: gradients, checkers, saturated
    blocks and dense noise — broad activation coverage without any files."""
    rng = np.random.default_rng(seed)
    out: list[np.ndarray] = []
    s = image_size
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / max(s - 1, 1)
    for i in range(n):
        kind = i % 4
        if kind == 0:
            img = np.stack([xx, yy, (xx + yy) / 2], axis=-1)
        elif kind == 1:
            img = (((yy * 8).astype(int) + (xx * 8).astype(int)) % 2)[..., None]
            img = np.repeat(img.astype(np.float32), 3, axis=-1)
        elif kind == 2:
            img = np.zeros((s, s, 3), np.float32)
            img[:, : s // 2, 0] = 1.0
            img[s // 2 :, :, 2] = 1.0
        else:
            img = rng.uniform(0, 1, size=(s, s, 3)).astype(np.float32)
        out.append((img * 255).astype(np.uint8))
    return out


def _synthetic_pixai_labels(n: int) -> list:
    """Synthetic label table with ips links: every CHARACTER row points at a
    COPYRIGHT row, so the propagation path is exercised without real CSVs."""
    from kobato_eyes_tpu_torch.models.base import TagCategory
    from kobato_eyes_tpu_torch.models.labels import synthetic_labels

    labels = synthetic_labels(n)
    copyrights = [m.name for m in labels if m.category == TagCategory.COPYRIGHT]
    if not copyrights:
        return labels
    k = 0
    for i, m in enumerate(labels):
        if m.category == TagCategory.CHARACTER:
            labels[i] = dataclasses.replace(m, ips=(copyrights[k % len(copyrights)],))
            k += 1
    return labels


def validate_checkpoint(
    path: str | Path,
    *,
    arch: str = "swinv2",
    preset: str = "base",
    image_size: int = 448,
    classes: int | None = None,
    labels_path: str | Path | None = None,
    thresholds: Mapping[int, float] | None = None,
    n_images: int = 8,
    prob_tolerance: float = DEFAULT_PROB_TOLERANCE,
    device: str | torch.device | None = None,
) -> dict[str, Any]:
    """Run import -> parity -> tag flips on ``device`` (default ``cuda``);
    returns the report.

    ``ok`` is True iff the import validated strictly, both forwards are
    finite, and the max per-label probability deviation is within the
    tolerance; tag flips are reported (count and names) and fail only when a
    flipped score sits further than the tolerance from its threshold.
    """
    if arch == "clip":
        # the CLIP lane lives with the embedder and the ANN indexes (index
        # layer; models must not import upward)
        raise ValueError(
            "arch='clip' is served by "
            "kobato_eyes_tpu_torch.index.validate.validate_clip_checkpoint "
            "(ket validate-checkpoint --arch clip dispatches there)"
        )
    if arch not in ("swinv2", "vit", "pixai"):
        raise ValueError(f"unknown arch {arch!r} (swinv2 | vit | pixai)")

    from kobato_eyes_tpu_torch.models.import_weights import import_torch_checkpoint
    from kobato_eyes_tpu_torch.models.labels import load_labels, synthetic_labels
    from kobato_eyes_tpu_torch.models.tagger import PixaiTagger, WD14Tagger

    path = Path(path)
    report: dict[str, Any] = {"path": str(path), "arch": arch, "preset": preset}

    pixai = arch == "pixai"
    backbone = "vit" if pixai else arch
    if labels_path is not None:
        labels = load_labels(labels_path)
    elif pixai:
        labels = _synthetic_pixai_labels(int(classes or 1024))
    else:
        labels = synthetic_labels(int(classes or 1024))
    n_classes = len(labels)
    report["classes"] = n_classes
    if pixai:
        report["ips_links"] = sum(1 for m in labels if m.ips)

    # --- 1. import (strict manifests) --------------------------------------
    if backbone == "swinv2":
        from kobato_eyes_tpu_torch.models.swin import swin_config

        cfg = swin_config(preset, image_size=image_size, num_classes=n_classes)
    else:
        from kobato_eyes_tpu_torch.models.vit import vit_config

        cfg = vit_config(preset, image_size=image_size, num_classes=n_classes)
    params = import_torch_checkpoint(path, cfg)  # raises with keys named
    report["import"] = "strict-manifest-ok"

    common: dict[str, Any] = dict(
        labels=labels, arch=backbone, preset=preset, image_size=image_size,
        params=params, thresholds=dict(thresholds) if thresholds else None, device=device,
    )
    if pixai:
        # the release layout ships normalisation statistics next to the model
        pj = path.parent / "preprocess.json"
        if pj.exists():
            common["preprocess_json"] = pj
        exact = PixaiTagger(fast_math=False, **common)
        fast = PixaiTagger(fast_math=True, **common)
        report["preprocess"] = {
            "mode": exact.spec.mode, "size": exact.spec.size,
            "mean": list(exact.spec.mean), "std": list(exact.spec.std),
            "from_json": "preprocess_json" in common,
        }
    else:
        exact = WD14Tagger(fast_math=False, **common)
        fast = WD14Tagger(fast_math=True, **common)
    report["fast_path"] = {"attn_impl": fast.cfg.attn_impl, "act": fast.cfg.act}

    # --- 2. exact-vs-fast forward parity -----------------------------------
    images = _synthetic_batch(image_size, n_images)
    batch = exact.prepare_batch_from_rgb(images)
    p_exact = exact.forward_probs(batch).float().cpu().numpy()
    p_fast = fast.forward_probs(batch).float().cpu().numpy()
    finite = bool(np.isfinite(p_exact).all() and np.isfinite(p_fast).all())
    dev = float(np.max(np.abs(p_exact - p_fast))) if finite else float("nan")
    report["finite"] = finite
    report["max_prob_deviation"] = dev
    report["prob_tolerance"] = float(prob_tolerance)

    # --- 3. tag parity at production thresholds ----------------------------
    thr_vec = exact._thr_vec_np  # includes the score floor
    hits_exact = p_exact >= thr_vec[None, :]
    hits_fast = p_fast >= thr_vec[None, :]
    flips = np.nonzero(hits_exact != hits_fast)
    flip_rows = []
    out_of_band = 0
    for img_i, lab_i in zip(*flips):
        gap = float(
            max(abs(p_exact[img_i, lab_i] - thr_vec[lab_i]),
                abs(p_fast[img_i, lab_i] - thr_vec[lab_i]))
        )
        if gap > prob_tolerance:
            out_of_band += 1
        flip_rows.append({
            "image": int(img_i),
            "tag": exact.names[int(lab_i)],
            "exact": round(float(p_exact[img_i, lab_i]), 5),
            "fast": round(float(p_fast[img_i, lab_i]), 5),
            "threshold": round(float(thr_vec[lab_i]), 5),
        })
    report["tag_flips"] = len(flip_rows)
    report["tag_flips_out_of_band"] = out_of_band
    report["tag_flip_examples"] = flip_rows[:10]

    report["ok"] = bool(finite and dev <= prob_tolerance and out_of_band == 0)

    # --- 4. (pixai) ips propagation probe ----------------------------------
    if pixai:
        report["ips_propagation_ok"] = _probe_ips_propagation(exact)
        report["ok"] = bool(report["ok"] and report["ips_propagation_ok"])
    return report


def _probe_ips_propagation(tagger) -> bool:
    """A crafted probability row — one above-threshold CHARACTER whose label
    carries an ips link — must surface the linked COPYRIGHT with at least the
    character's score (the tagger's own selection, device then host)."""
    from kobato_eyes_tpu_torch.models.base import TagCategory
    from kobato_eyes_tpu_torch.models.postprocess import resolve_limits
    from kobato_eyes_tpu_torch.models.tagger import fetch

    char = next(
        (
            m for m in tagger.labels
            if m.category == TagCategory.CHARACTER and m.ips
            and tagger._name_to_idx.get(m.ips[0]) is not None
        ),
        None,
    )
    if char is None:
        logger.warning("ips probe skipped: no character label carries an ips link")
        return True  # nothing to propagate in this table
    probs = np.zeros((1, len(tagger.labels)), dtype=np.float32)
    probs[0, tagger._name_to_idx[char.name]] = 0.95
    limits = resolve_limits(tagger.max_tags, None)
    pending = tagger._select_device(
        torch.from_numpy(probs).to(tagger.device), tagger._thr_vec_np, limits
    )
    results = tagger._select_host(fetch(pending), limits, None)
    got = {t.name: t.score for t in results[0].tags}
    ip = char.ips[0]
    return bool(char.name in got and ip in got and got[ip] >= got[char.name] - 1e-6)
