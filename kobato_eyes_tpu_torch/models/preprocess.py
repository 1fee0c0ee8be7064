"""Tagger input preprocessing: host layout + device normalization.

Counterpart of ``kobato_eyes_tpu/models/preprocess.py``. The host geometry
(numpy/PIL, ragged -> fixed shape) is the same code; the device step is
torch on the tagger's device:

  wd14  — white square pad, resize to ``size``, RGB->BGR, float 0..255
  pixai — short side to ``size``, center crop, /255, (x-mean)/std
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from PIL import Image

# PixAI preprocess.json stages use ImageNet-standard statistics.
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# CLIP's own training statistics (OpenAI + open_clip defaults).
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclass(frozen=True)
class PreprocessSpec:
    """Declarative preprocess convention attached to a tagger."""

    mode: str  # "wd14" | "pixai" | "unit"
    size: int = 448
    mean: tuple[float, float, float] = IMAGENET_MEAN
    std: tuple[float, float, float] = IMAGENET_STD


# ---------------------------------------------------------------------------
# Host geometric step (ragged -> fixed shape)
# ---------------------------------------------------------------------------


def spec_from_preprocess_json(path, *, mode: str = "pixai", size: int = 448) -> PreprocessSpec:
    """Build a spec from a PixAI-style ``preprocess.json`` stage list
    (reference pixai_onnx.py:94-104: normalization stage carries mean/std)."""
    import json
    from pathlib import Path

    doc = json.loads(Path(path).read_text(encoding="utf-8"))
    stages = doc.get("stages", doc if isinstance(doc, list) else [])
    mean, std = IMAGENET_MEAN, IMAGENET_STD
    for stage in stages:
        if not isinstance(stage, dict):
            continue
        if "mean" in stage and "std" in stage:
            mean = tuple(float(x) for x in stage["mean"])
            std = tuple(float(x) for x in stage["std"])
        if stage.get("type") in ("resize", "crop") and "size" in stage:
            raw = stage["size"]
            size = int(raw[0] if isinstance(raw, (list, tuple)) else raw)
    return PreprocessSpec(mode=mode, size=size, mean=mean, std=std)


def letterbox_square_rgb(arr: np.ndarray, size: int) -> np.ndarray:
    """White square pad then resize to (size, size); uint8 RGB in/out."""
    h, w = arr.shape[:2]
    side = max(h, w)
    if h != w:
        canvas = np.full((side, side, 3), 255, dtype=np.uint8)
        top = (side - h) // 2
        left = (side - w) // 2
        canvas[top : top + h, left : left + w] = arr
        arr = canvas
    if side != size:
        # AREA-like downsample / CUBIC upsample choice of the reference
        # (wd14_preprocessing.py:25-32); PIL's BOX ~ AREA, BICUBIC ~ CUBIC.
        resample = Image.Resampling.BOX if side > size else Image.Resampling.BICUBIC
        arr = np.asarray(Image.fromarray(arr).resize((size, size), resample), dtype=np.uint8)
    return arr


def shortside_centercrop_rgb(arr: np.ndarray, size: int) -> np.ndarray:
    """Scale short side to ``size`` then center crop; uint8 RGB in/out."""
    h, w = arr.shape[:2]
    scale = size / min(h, w)
    nh, nw = max(size, round(h * scale)), max(size, round(w * scale))
    if (nh, nw) != (h, w):
        arr = np.asarray(
            Image.fromarray(arr).resize((nw, nh), Image.Resampling.BICUBIC), dtype=np.uint8
        )
    top = (nh - size) // 2
    left = (nw - size) // 2
    return arr[top : top + size, left : left + size]


def prepare_batch(images: list[np.ndarray], spec: PreprocessSpec) -> np.ndarray:
    """List of HxWx3 uint8 RGB -> (B, size, size, 3) uint8 batch."""
    geo = letterbox_square_rgb if spec.mode == "wd14" else shortside_centercrop_rgb
    return np.stack([geo(a, spec.size) for a in images])


# ---------------------------------------------------------------------------
# Device normalization (runs on the batch's device, before the forward)
# ---------------------------------------------------------------------------


def mean_std_on_device(spec: PreprocessSpec, device: torch.device | str) -> tuple[torch.Tensor, torch.Tensor]:
    """``spec``'s mean and std as float32 tensors on ``device``."""
    return (torch.tensor(spec.mean, dtype=torch.float32, device=device),
            torch.tensor(spec.std, dtype=torch.float32, device=device))


def normalize_on_device(
    batch: torch.Tensor,
    spec: PreprocessSpec,
    mean_std: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """(B, H, W, 3) uint8 (or the embedder's mean-pooled float32 0..255)
    -> float32 NHWC in the model's expected convention. ``mean_std``: the
    pixai mode's :func:`mean_std_on_device` on the batch's device, made once
    by the caller (a CUDA graph capture copies nothing from the host); made
    here when None."""
    x = batch.to(torch.float32)
    if spec.mode == "wd14":
        return x.flip(-1)  # RGB -> BGR, keep 0..255 un-normalized
    if spec.mode == "pixai":
        x = x / 255.0
        mean, std = mean_std if mean_std is not None else mean_std_on_device(spec, x.device)
        return (x - mean) / std
    if spec.mode == "unit":
        return x / 255.0
    raise ValueError(f"unknown preprocess mode {spec.mode!r}")
