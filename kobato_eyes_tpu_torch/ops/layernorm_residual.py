"""Residual-fused LayerNorm ``shortcut + LN(x)``: the hand-written CUDA kernel and
its plain version.

Replaces the JAX package's residual LayerNorm Pallas kernel
(``kobato_eyes_tpu/ops/pallas_layernorm_residual.py``: ``_ln_res_kernel``
through ``_ln_res_call`` / ``layernorm_residual``): f32 statistics with
E[x^2] - E[x]^2 (no clamp), eps inside the rsqrt,
``(x - mean) * inv * gamma + beta``, the shortcut added in f32, one rounding
to x's dtype at the end.

On the card the bound is bytes: x and the shortcut read once, the output
written once (308 MB at SwinV2-B/448 stage 0, batch 32). The CUDA kernel
(``csrc/layernorm_residual.cu``) gives each row to one warp, which keeps the
row in registers between its statistics and the apply pass. It takes any
C up to 1024; the JAX package's ``C % 128`` fallback was a TPU tiling limit
and computes the same formula.

A wrapper launches the kernel for a CUDA tensor and raises if the launch
fails; it takes the plain version only for a CPU tensor. ``launches`` counts
the kernel launches in this process.
"""

from __future__ import annotations

import ctypes

import torch

launches = 0

_SOURCE = "layernorm_residual.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHANNELS = 1024


def layernorm_residual_plain(
    x: torch.Tensor, shortcut: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
    *, eps: float = 1e-5,
) -> torch.Tensor:
    """``shortcut + LayerNorm(x)`` step for step as ``_ln_res_kernel``."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf * xf).mean(dim=-1, keepdim=True) - mean * mean
    y = (xf - mean) * torch.rsqrt(var + eps) * gamma.float() + beta.float()
    return (shortcut.float() + y).to(x.dtype)


def _library() -> ctypes.CDLL:
    from kobato_eyes_tpu_torch.ops.build import load

    lib = load(_SOURCE)
    fn = lib.layernorm_residual_launch
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 5
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
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
    *, eps: float = 1e-5,
) -> torch.Tensor:
    """``shortcut + LayerNorm(x)`` over the last axis, any leading shape."""
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
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.layernorm_residual_launch(
        x2.data_ptr(), res2.data_ptr(), g32.data_ptr(), b32.data_ptr(), out.data_ptr(),
        x2.shape[0], c, _DTYPE_CODES[x.dtype], float(eps), stream,
    )
    if err != 0:
        raise RuntimeError(f"layernorm_residual launch failed: cudaError_t {err}")
    launches += 1
    return out.reshape(x.shape)
