"""Duplicate-detection engine: device candidate scan + host clustering."""

from kobato_eyes_tpu_torch.dup.types import (
    DuplicateCluster,
    DuplicateClusterEntry,
    DuplicateFileMeta,
    DuplicateScanConfig,
)
from kobato_eyes_tpu_torch.dup.engine import TpuDuplicateScanner

__all__ = [
    "DuplicateCluster",
    "DuplicateClusterEntry",
    "DuplicateFileMeta",
    "DuplicateScanConfig",
    "TpuDuplicateScanner",
]
