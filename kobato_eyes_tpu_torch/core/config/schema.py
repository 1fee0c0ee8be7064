"""Validated settings schema.

Mirrors the knob set of the reference (``src/core/config/schema.py:56-213``:
roots / excluded / allow_exts / batch_size / prefetch_depth / hamming /
ssim thresholds / tagger name+thresholds+max-tags) and adds the TPU-engine
knobs (mesh shape, dtype policy, device batch sizes).
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

from pydantic import BaseModel, Field, field_validator

DEFAULT_ALLOW_EXTS = [
    ".jpg", ".jpeg", ".jpe", ".jfif", ".png", ".apng", ".webp",
    ".bmp", ".gif", ".tif", ".tiff",
]

# Search-threshold defaults shared with the query engine
# (reference db/common.py:14-18: general=.35 character=.25 copyright=.25).
DEFAULT_CATEGORY_THRESHOLDS: dict[int, float] = {0: 0.35, 4: 0.25, 3: 0.25}


class TaggerSettings(BaseModel):
    """Tagger model selection and scoring policy."""

    name: str = "dummy"  # dummy | wd14 | pixai
    model_path: Path | None = None  # checkpoint (orbax/msgpack) or ONNX to import
    labels_path: Path | None = None  # selected_tags.csv-style label file
    thresholds: dict[int, float] = Field(default_factory=lambda: dict(DEFAULT_CATEGORY_THRESHOLDS))
    max_tags: dict[int, int | None] = Field(default_factory=dict)
    score_floor: float = 0.1  # global floor (reference wd14_onnx.py:225)
    topk_cap: int = 128  # hard per-image cap (reference wd14_onnx.py:224)

    @field_validator("thresholds", mode="before")
    @classmethod
    def _coerce_thresholds(cls, value: object) -> dict[int, float]:
        if value is None:
            return dict(DEFAULT_CATEGORY_THRESHOLDS)
        if isinstance(value, dict):
            return {int(k): float(v) for k, v in value.items()}
        raise TypeError("thresholds must be a mapping of category->float")


class DupSettings(BaseModel):
    """Duplicate-scan candidate generation (reference dup/scanner.py:147-155)."""

    hamming_threshold: int = Field(default=8, ge=0, le=64)
    band_bits: int = Field(default=16, gt=0)
    band_count: int = Field(default=4, gt=0)
    size_ratio: float | None = None
    cosine_threshold: float | None = None
    bucket_pair_cap: int | None = None

    @field_validator("band_count")
    @classmethod
    def _bands_fit(cls, v: int, info) -> int:
        bits = info.data.get("band_bits", 16)
        if bits * v > 64:
            raise ValueError("band_bits * band_count must be <= 64")
        return v


class RefineSettings(BaseModel):
    """Cluster refinement (reference ui/dup_refine_parallel.py defaults and
    the app-level params grid=8 tile=8 max_bits=8 mae=0.004; dup/refine.py
    ssim=0.9 orb=0.15)."""

    grid: int = Field(default=8, ge=2, le=16)
    tile: int = Field(default=8, ge=2, le=16)
    max_bits: int = Field(default=8, ge=0, le=128)
    mae_threshold: float = 0.004
    mae_size: int = 128
    ssim_threshold: float = 0.9
    orb_threshold: float = 0.15


class IndexSettings(BaseModel):
    """ANN vector path (activates the reference's dormant src/index stub)."""

    enabled: bool = False
    embed_dim: int = 512
    preset: str = "base"
    image_size: int = 224
    patch_size: int = 32
    checkpoint: Path | None = None
    # Fuse the embedding forward into the tag stage's device dispatch when
    # the tagger's prepared geometry allows it (wd14 letterbox at an integer
    # multiple of image_size): one decode, one upload per batch — the embed
    # stage's own decode+upload pass was 23% of the cold index wall
    # (docs/benchmarks.md r5 attribution). The prep geometry vectors were
    # computed with persists in the catalog meta table; changing it
    # invalidates stored vectors (db.repository.ensure_embed_prep).
    fused: bool = True


class MeshSettings(BaseModel):
    """Device-mesh layout for multi-chip runs."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = -1  # -1: all devices on the data axis
    model_parallel: int = 1


class PipelineSettings(BaseModel):
    """Scan/tag/write pipeline configuration."""

    roots: list[Path] = Field(default_factory=list)
    excluded: list[Path] = Field(default_factory=list)
    allow_exts: list[str] = Field(default_factory=lambda: list(DEFAULT_ALLOW_EXTS))
    batch_size: int = Field(default=32, ge=1, le=512)
    prefetch_depth: int = Field(default=4, ge=1, le=64)
    io_workers: int = Field(default=8, ge=1, le=64)
    hash_batch_size: int = Field(default=4096, ge=1)
    # in-flight tagger batches before the oldest result is fetched (>1
    # overlaps relay round trips with device compute; 1 = sync per batch)
    pipeline_depth: int = Field(default=3, ge=1, le=16)
    # prepared-tensor cache (reference KE_TAGGER_INPUT_CACHE, loaders.py:205-225)
    tagger_input_cache: bool = False
    input_cache_dir: Path | None = None
    # Fuse duplicate-signature (pHash/dHash) computation into the tag stage:
    # files being tagged that lack signature rows get them from the SAME
    # decode, so `ket dup` after `ket index` needs no second decode pass
    # over the library (the reference recomputes signatures in a separate
    # fan-out, src/core/fastsig.py). Cache-hit and downgraded batches fall
    # back to the standalone compute_signatures lane.
    inline_signatures: bool = True

    @field_validator("allow_exts", mode="before")
    @classmethod
    def _normalize_exts(cls, value: Sequence[str] | None) -> list[str]:
        if not value:
            return list(DEFAULT_ALLOW_EXTS)
        out = []
        for ext in value:
            e = str(ext).lower().strip()
            if not e.startswith("."):
                e = "." + e
            out.append(e)
        return out


class Settings(BaseModel):
    """Top-level settings document."""

    pipeline: PipelineSettings = Field(default_factory=PipelineSettings)
    tagger: TaggerSettings = Field(default_factory=TaggerSettings)
    dup: DupSettings = Field(default_factory=DupSettings)
    refine: RefineSettings = Field(default_factory=RefineSettings)
    index: IndexSettings = Field(default_factory=IndexSettings)
    mesh: MeshSettings = Field(default_factory=MeshSettings)
    data_dir: Path | None = None
