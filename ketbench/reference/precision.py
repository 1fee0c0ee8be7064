"""Operand rounding for the references' lower-precision controls."""

from __future__ import annotations

import torch

FP8_MAX = 448.0  # largest finite float8_e4m3fn


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` through float8 e4m3 with one scale for the tensor (its largest
    magnitude to 448), back in float32: a matmul operand as an fp8 path
    would feed it."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def operand_rounding(precision: str):
    """The rounding applied to each product's operands: none for
    ``"float32"``, fp8 for ``"fp8"``."""
    if precision == "float32":
        return lambda x: x
    if precision == "fp8":
        return fp8_round
    raise ValueError(f"unknown reference precision {precision!r}")


class exact_float32:
    """Context: float32 products without TF32 (matmul and cuDNN)."""

    def __enter__(self):
        self._saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self._saved
        return False
