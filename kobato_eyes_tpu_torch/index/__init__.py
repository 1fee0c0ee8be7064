"""ANN vector index: CLIP-style embeddings + exact / IVF-Flat / HNSW search.

Counterpart of ``kobato_eyes_tpu/index``: embeddings come from the port's
ViT on the device, exact and IVF-Flat search are f32 matmuls and top-ks on
the device, and HNSW keeps its graph on the host (C++ runtime).
"""

from kobato_eyes_tpu_torch.index.flat import FlatIndex
from kobato_eyes_tpu_torch.index.ivf import IvfFlatIndex, kmeans

__all__ = ["FlatIndex", "IvfFlatIndex", "kmeans"]
