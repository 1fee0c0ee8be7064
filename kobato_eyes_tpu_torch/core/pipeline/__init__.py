"""Index pipeline: Scan -> Tag -> Write."""

from kobato_eyes_tpu_torch.core.pipeline.orchestrator import IndexPipeline, IndexStats, run_index_once

__all__ = ["IndexPipeline", "IndexStats", "run_index_once"]
