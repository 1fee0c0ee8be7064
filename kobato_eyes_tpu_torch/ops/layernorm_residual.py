"""Residual-fused LayerNorm ``shortcut + LN(x)``: the hand-written CUDA kernel and
its plain version.

Replaces the JAX package's residual LayerNorm Pallas kernel
(``kobato_eyes_tpu/ops/pallas_layernorm_residual.py``: ``_ln_res_kernel``
through ``_ln_res_call`` / ``layernorm_residual``): f32 statistics with
E[x^2] - E[x]^2 (no clamp), eps inside the rsqrt, which is XLA's CPU rsqrt
as the JAX kernel's ``jax.lax.rsqrt`` is there (``xla_math.rsqrt_plain``;
``csrc/xla_rsqrt.cuh`` in the kernel, with the host's estimate table),
``(x - mean) * inv * gamma + beta``, the shortcut added in f32, one rounding
to x's dtype at the end.

On the card the bound is bytes: x and the shortcut read once, the output
written once (308 MB at SwinV2-B/448 stage 0, batch 32). The CUDA source
(``csrc/layernorm_residual.cu``) holds two kernels and ``kernel_variant``
says which one a call runs, by shape and alignment alone:

* ``"vec8"``: C a multiple of 8 and x, shortcut, gamma, beta and the output
  at addresses that are multiples of 16 bytes (every SwinV2 stage). A lane
  owns chunks of 8 consecutive columns (16-byte loads), a row is spread
  over 8, 16 or 32 lanes (C = 128: two rows a warp; C = 1024: four chunks a
  lane), and x and the shortcut are both in flight before the first
  reduction.
* ``"scalar"``: the rest (any C up to 1024, any alignment): a warp a row,
  one element a load.

Both keep a row in registers between its statistics and the apply pass. The
JAX package's ``C % 128`` fallback was a TPU tiling limit and computes the
same formula.

A wrapper launches the kernel for a CUDA tensor and raises if the launch
fails; it takes the plain version only for a CPU tensor. ``launches`` counts
the kernel launches in this process.
"""

from __future__ import annotations

import ctypes

import torch

from kobato_eyes_tpu_torch.ops.xla_math import rsqrt_estimate_table, rsqrt_plain

launches = 0

_SOURCE = "layernorm_residual.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_VARIANT_CODES = {"scalar": 0, "vec8": 1}
MAX_CHANNELS = 1024


def kernel_variant(channels: int, *, aligned: bool = True) -> str:
    """Which kernel of ``csrc/layernorm_residual.cu`` a CUDA call runs.

    ``"vec8"`` (16-byte loads, 8 consecutive columns a lane) takes rows
    whose C is a multiple of 8 with every tensor at a multiple of 16 bytes
    (``aligned``); ``"scalar"`` takes the rest.
    """
    return "vec8" if channels % 8 == 0 and aligned else "scalar"


def aligned_for_vec(*tensors: torch.Tensor) -> bool:
    """Whether every tensor starts at a multiple of 16 bytes."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def layernorm_residual_plain(
    x: torch.Tensor, shortcut: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
    *, eps: float = 1e-5,
) -> torch.Tensor:
    """``shortcut + LayerNorm(x)`` step for step as ``_ln_res_kernel``."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf * xf).mean(dim=-1, keepdim=True) - mean * mean
    y = (xf - mean) * rsqrt_plain(var + eps) * gamma.float() + beta.float()
    return (shortcut.float() + y).to(x.dtype)


def _library() -> ctypes.CDLL:
    from kobato_eyes_tpu_torch.ops.build import load

    lib = load(_SOURCE)
    fn = lib.layernorm_residual_launch
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 5
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
               ctypes.c_void_p, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return lib


def check_inputs(x: torch.Tensor, shortcut: torch.Tensor, gamma: torch.Tensor,
                 beta: torch.Tensor) -> None:
    """Raise on what the kernel does not take: CUDA tensors on one device, x
    and shortcut of one shape and dtype (float32 or bfloat16), C up to 1024,
    gamma and beta of shape (C,)."""
    for t in (x, shortcut, gamma, beta):
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"layernorm_residual kernel needs CUDA tensors on one device, got {t.device}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"layernorm_residual kernel takes float32 or bfloat16, got {x.dtype}")
    if shortcut.shape != x.shape or shortcut.dtype != x.dtype:
        raise ValueError("x and shortcut must share shape and dtype")
    c = x.shape[-1]
    if not 1 <= c <= MAX_CHANNELS:
        raise ValueError(f"layernorm_residual kernel takes 1 <= C <= {MAX_CHANNELS}, got {c}")
    if tuple(gamma.shape) != (c,) or tuple(beta.shape) != (c,):
        raise ValueError(f"gamma and beta must be ({c},)")


def layernorm_residual(
    x: torch.Tensor, shortcut: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
    *, eps: float = 1e-5, variant: str | None = None,
) -> torch.Tensor:
    """``shortcut + LayerNorm(x)`` over the last axis, any leading shape.

    ``variant`` names the kernel instead of ``kernel_variant`` (to time one
    beside the other); ``"vec8"`` on rows it does not take raises.
    """
    global launches
    if x.device.type == "cpu":
        return layernorm_residual_plain(x, shortcut, gamma, beta, eps=eps)
    check_inputs(x, shortcut, gamma, beta)
    c = x.shape[-1]
    x2 = x.reshape(-1, c).contiguous()
    res2 = shortcut.reshape(-1, c).contiguous()
    g32 = gamma.float().contiguous()
    b32 = beta.float().contiguous()
    out = torch.empty_like(x2)
    if x2.shape[0] == 0:
        return out.reshape(x.shape)
    chosen = kernel_variant(c, aligned=aligned_for_vec(x2, res2, g32, b32, out))
    if variant is None:
        variant = chosen
    elif variant not in _VARIANT_CODES or (variant == "vec8" and chosen != "vec8"):
        raise ValueError(f"layernorm_residual variant {variant!r} does not take these rows (C={c})")
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.layernorm_residual_launch(
        x2.data_ptr(), res2.data_ptr(), g32.data_ptr(), b32.data_ptr(), out.data_ptr(),
        x2.shape[0], c, _DTYPE_CODES[x.dtype], _VARIANT_CODES[variant], float(eps),
        rsqrt_estimate_table().ctypes.data, stream,
    )
    if err != 0:
        raise RuntimeError(f"layernorm_residual launch failed: cudaError_t {err}")
    launches += 1
    return out.reshape(x.shape)
