"""HNSW ANN index: C++ graph runtime + optional device re-rank.

ctypes facade over ``kobato_eyes_tpu_torch/native/hnsw.cpp``.  Graph walks run in
native host code (pointer-chasing is a CPU workload); candidate re-ranking
against the exact corpus can run on device via FlatIndex when higher
precision@k is needed than the graph's ef provides.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from kobato_eyes_tpu_torch.native.build import load_native_library

_c_float_p = ctypes.POINTER(ctypes.c_float)
_c_int64_p = ctypes.POINTER(ctypes.c_int64)
_c_int32_p = ctypes.POINTER(ctypes.c_int32)


def _lib() -> ctypes.CDLL:
    lib = load_native_library("hnsw")
    if not getattr(lib, "_hnsw_bound", False):
        lib.hnsw_create.restype = ctypes.c_void_p
        lib.hnsw_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint32]
        lib.hnsw_free.argtypes = [ctypes.c_void_p]
        lib.hnsw_size.restype = ctypes.c_int64
        lib.hnsw_size.argtypes = [ctypes.c_void_p]
        lib.hnsw_dim.restype = ctypes.c_int
        lib.hnsw_dim.argtypes = [ctypes.c_void_p]
        lib.hnsw_add_batch.argtypes = [ctypes.c_void_p, _c_float_p, _c_int64_p, ctypes.c_int64]
        lib.hnsw_search_batch.argtypes = [
            ctypes.c_void_p, _c_float_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            _c_int64_p, _c_float_p, _c_int32_p,
        ]
        lib.hnsw_save.restype = ctypes.c_int
        lib.hnsw_save.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.hnsw_load.restype = ctypes.c_int
        lib.hnsw_load.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib._hnsw_bound = True
    return lib


class HnswIndex:
    """Cosine/IP HNSW over unit vectors."""

    def __init__(self, dim: int, *, M: int = 16, ef_construction: int = 200, seed: int = 0) -> None:
        self._libref = _lib()
        self._handle = self._libref.hnsw_create(dim, M, ef_construction, seed)
        self.dim = dim

    def __len__(self) -> int:
        return int(self._libref.hnsw_size(self._handle))

    def __del__(self) -> None:
        handle = getattr(self, "_handle", None)
        if handle:
            self._libref.hnsw_free(handle)
            self._handle = None

    @staticmethod
    def _normalize(vecs: np.ndarray) -> np.ndarray:
        v = np.ascontiguousarray(vecs, dtype=np.float32)
        norms = np.linalg.norm(v, axis=1, keepdims=True)
        return v / np.maximum(norms, 1e-30)

    def add(self, vectors: np.ndarray, ids: np.ndarray | None = None) -> None:
        v = self._normalize(np.atleast_2d(vectors))
        if v.shape[1] != self.dim:
            raise ValueError(f"expected dim {self.dim}, got {v.shape[1]}")
        n = v.shape[0]
        if ids is None:
            start = len(self)
            ids = np.arange(start, start + n, dtype=np.int64)
        ids = np.ascontiguousarray(ids, dtype=np.int64)
        self._libref.hnsw_add_batch(
            self._handle, v.ctypes.data_as(_c_float_p), ids.ctypes.data_as(_c_int64_p), n
        )

    def search(
        self, queries: np.ndarray, k: int = 10, *, ef: int = 64
    ) -> tuple[np.ndarray, np.ndarray]:
        """(Q, D) -> (scores, ids) of shape (Q, k); -1 id padding."""
        q = self._normalize(np.atleast_2d(queries))
        nq = q.shape[0]
        k = max(1, min(k, max(len(self), 1)))
        out_ids = np.empty((nq, k), dtype=np.int64)
        out_scores = np.empty((nq, k), dtype=np.float32)
        out_counts = np.empty(nq, dtype=np.int32)
        self._libref.hnsw_search_batch(
            self._handle, q.ctypes.data_as(_c_float_p), nq, k, max(ef, k),
            out_ids.ctypes.data_as(_c_int64_p), out_scores.ctypes.data_as(_c_float_p),
            out_counts.ctypes.data_as(_c_int32_p),
        )
        return out_scores, out_ids

    def save(self, path: str | Path) -> None:
        if self._libref.hnsw_save(self._handle, str(path).encode()) != 0:
            raise OSError(f"hnsw save failed: {path}")

    @classmethod
    def load(cls, path: str | Path, *, dim: int, M: int = 16, ef_construction: int = 200) -> "HnswIndex":
        idx = cls(dim, M=M, ef_construction=ef_construction)
        if idx._libref.hnsw_load(idx._handle, str(path).encode()) != 0:
            raise OSError(f"hnsw load failed: {path}")
        idx.dim = int(idx._libref.hnsw_dim(idx._handle))
        return idx
