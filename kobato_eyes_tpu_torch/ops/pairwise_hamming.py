"""All-pairs Hamming distances over 64-bit hashes: the hand-written CUDA kernel
and its plain version.

Replaces the JAX package's tiled Hamming Pallas kernel
(``kobato_eyes_tpu/ops/pallas_hamming.py``: ``_hamming_tile_kernel`` through
``_pairwise_kernel`` / ``pairwise_hamming``): ``out[i, j] =
popcount(a[i] ^ b[j])`` as int32. Its one consumer is the cluster cohesion
audit (``dup/audit.py``, ``ket dup --audit``).

On the card the bound is bytes, almost all of them the output: Na * Nb * 4
bytes written against (Na + Nb) * 8 read (67.1 MB at the audit's 4096 x 4096
batch, 0.0200 ms at 3.35 TB/s). The CUDA kernel
(``csrc/pairwise_hamming.cu``) reads each hash as one int64 and computes
``__popcll(a ^ b)``; consecutive threads own consecutive columns of a row so
every warp's stores are coalesced. Torch has no popcount, so no single
PyTorch call computes this function.

The hashes travel as int64 tensors holding the uint64 bits. A wrapper
launches the kernel for a CUDA tensor and raises if the launch fails; it
takes the plain version only for a CPU tensor. ``launches`` counts the
kernel launches in this process.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from kobato_eyes_tpu_torch.device import resolve_device
from kobato_eyes_tpu_torch.ops.hamming import popcount32, split_halves
from kobato_eyes_tpu_torch.utils.bits import popcount64_np

launches = 0

_SOURCE = "pairwise_hamming.cu"


def pairwise_hamming_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(Na,) x (Nb,) int64 -> (Na, Nb) int32 by a SWAR popcount over the
    32-bit halves of ``a[:, None] ^ b[None, :]``."""
    hi, lo = split_halves(a[:, None] ^ b[None, :])
    return (popcount32(hi) + popcount32(lo)).to(torch.int32)


def _library() -> ctypes.CDLL:
    from kobato_eyes_tpu_torch.ops.build import load

    lib = load(_SOURCE)
    fn = lib.pairwise_hamming_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def check_inputs(a: torch.Tensor, b: torch.Tensor) -> None:
    """Raise on what the kernel does not take: 1-D int64 CUDA tensors on one
    device."""
    for t in (a, b):
        if t.device != a.device or t.device.type != "cuda":
            raise ValueError(f"pairwise_hamming kernel needs CUDA tensors on one device, got {t.device}")
        if t.dtype != torch.int64 or t.dim() != 1:
            raise ValueError(f"pairwise_hamming kernel takes 1-D int64 hashes, got {t.dtype} {tuple(t.shape)}")


def pairwise_hamming_tensor(a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """(Na,) x (Nb,) int64 hashes -> (Na, Nb) int32 distances, on a's device."""
    global launches
    if b is None:
        b = a
    if a.device.type == "cpu":
        return pairwise_hamming_plain(a, b)
    check_inputs(a, b)
    a = a.contiguous()
    b = b.contiguous()
    out = torch.empty((a.shape[0], b.shape[0]), dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out
    lib = _library()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = lib.pairwise_hamming_launch(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0], b.shape[0], stream
    )
    if err != 0:
        raise RuntimeError(f"pairwise_hamming launch failed: cudaError_t {err}")
    launches += 1
    return out


def hashes_to_tensor(h_u64: np.ndarray, device) -> torch.Tensor:
    """(N,) uint64 (or anything numpy reads as such) -> int64 tensor of the
    same bits on ``device``."""
    arr = np.ascontiguousarray(np.asarray(h_u64, dtype=np.uint64)).view(np.int64)
    return torch.from_numpy(arr).to(device)


def pairwise_hamming(
    a_u64: np.ndarray, b_u64: np.ndarray | None = None, *, device=None
) -> np.ndarray:
    """(Na,) x (Nb,) uint64 hashes -> (Na, Nb) int32 Hamming distance matrix."""
    dev = resolve_device(device)
    a = hashes_to_tensor(a_u64, dev)
    b = a if b_u64 is None else hashes_to_tensor(b_u64, dev)
    return pairwise_hamming_tensor(a, b).cpu().numpy()


def pairwise_hamming_np(a_u64: np.ndarray, b_u64: np.ndarray | None = None) -> np.ndarray:
    """numpy executable spec."""
    if b_u64 is None:
        b_u64 = a_u64
    a = np.asarray(a_u64, dtype=np.uint64)
    b = np.asarray(b_u64, dtype=np.uint64)
    return popcount64_np(a[:, None] ^ b[None, :]).astype(np.int32)
