"""Tagger data model and protocol.

Parity with the reference contract (``src/tagger/base.py:13-66``): the same
six Danbooru categories, the same prediction/result shapes, and a batch
protocol split into *prepare* (host-side decode/layout) and *infer*
(device-side forward + postprocess) so the pipeline can prefetch prepared
batches while the device is busy.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum
from typing import Mapping, Protocol, Sequence, runtime_checkable

import numpy as np


class TagCategory(IntEnum):
    GENERAL = 0
    ARTIST = 1
    RATING = 2
    COPYRIGHT = 3
    CHARACTER = 4
    META = 5


# category -> threshold / max-tags (reference base.py ThresholdMap/MaxTagsMap)
ThresholdMap = Mapping[int, float]
MaxTagsMap = Mapping[int, int | None]

# Reference provider-default policies (src/core/pipeline/utils.py:14-37).
WD14_DEFAULT_THRESHOLDS: dict[int, float] = {0: 0.35, 4: 0.25, 3: 0.25}
PIXAI_DEFAULT_THRESHOLDS: dict[int, float] = {0: 0.4, 4: 0.8, 3: 0.8}
PIXAI_DEFAULT_MAX_TAGS: dict[int, int | None] = {0: 128, 4: 10, 3: 10}

# Global score floor + hard top-K cap (reference wd14_onnx.py:224-225).
DEFAULT_SCORE_FLOOR = 0.1
DEFAULT_TOPK_CAP = 128


@dataclass(frozen=True)
class TagPrediction:
    name: str
    score: float
    category: TagCategory


@dataclass(frozen=True)
class TagResult:
    tags: list[TagPrediction] = field(default_factory=list)


@runtime_checkable
class ITagger(Protocol):
    """Batch tagger protocol (reference tagger/base.py:45-66)."""

    @property
    def input_size(self) -> int: ...

    def prepare_batch_from_rgb(self, images: Sequence[np.ndarray]) -> np.ndarray:
        """Host-side: list of HxWx3 uint8 RGB -> model-ready batch array."""
        ...

    def infer_batch_prepared(
        self,
        batch: np.ndarray,
        *,
        thresholds: ThresholdMap | None = None,
        max_tags: MaxTagsMap | None = None,
    ) -> list[TagResult]:
        """Device-side: prepared batch -> per-image tag results."""
        ...

    def infer_batch(
        self,
        images: Sequence[np.ndarray],
        *,
        thresholds: ThresholdMap | None = None,
        max_tags: MaxTagsMap | None = None,
    ) -> list[TagResult]: ...

    def signature_fields(self) -> dict[str, str]:
        """Stable identity fields for the tagger fingerprint (retag key)."""
        ...
