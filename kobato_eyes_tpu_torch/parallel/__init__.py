"""Multi-device execution: device meshes, sharding rules, sharded paths.

Counterpart of ``kobato_eyes_tpu/parallel``: data-parallel sharding of
batches and index shards over a (data, model) mesh of ``torch.device``
entries, with tensor parallelism for the ViT tagger; copies between entries
are explicit (``parallel/mesh.py``).
"""

from kobato_eyes_tpu_torch.parallel.mesh import make_mesh, shard_batch, shard_params

__all__ = ["make_mesh", "shard_batch", "shard_params"]
