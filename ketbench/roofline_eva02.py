"""The yardstick's arithmetic for EVA02 (the PixAI tagging cell): the
forward's operations, kernel 1's launches at EVA02's shape and the RoPE
kernel's bytes. Peaks and the bound are ``roofline``'s.

``eva02_forward_flops`` is a frozen copy of the port's
(``models/eva02.py``): analytic matmul FLOPs, two a multiply-add; the
rotation, norms and elementwise work left out. EVA02-L/14 at 448: 723.5
GFLOP an image.
"""

from __future__ import annotations

from ketbench.roofline import head_attention_launch


def eva02_forward_flops(cfg: dict, batch_size: int, *, with_head: bool = True) -> float:
    d, p, hidden = cfg["hidden_size"], cfg["patch_size"], cfg["intermediate_size"]
    n = (cfg["image_size"] // p) ** 2
    t = n + 1
    patch = 2 * n * (p**2 * 3) * d
    per_layer = (
        2 * t * d * 3 * d
        + 2 * 2 * t * t * d
        + 2 * t * d * d
        + 2 * 2 * t * d * hidden
        + 2 * t * hidden * d
    )
    head = 2 * d * cfg["num_labels"] if with_head else 0
    return float(batch_size) * (patch + cfg["num_hidden_layers"] * per_layer + head)


def _shape(cfg: dict) -> tuple[int, int, int]:
    """(tokens with the class token, heads, head width)."""
    h = cfg["num_attention_heads"]
    return (cfg["image_size"] // cfg["patch_size"]) ** 2 + 1, h, cfg["hidden_size"] // h


def eva02_attention_launches(cfg: dict, batch_size: int) -> list[tuple[float, float]]:
    """Kernel 1's launches in one EVA02 forward: one a layer, over the
    packed (B, T, 3, H, D) projection (EVA02-L/448 at batch 32: 137.7 GFLOP,
    268.7 MB a launch)."""
    t, h, d = _shape(cfg)
    return [head_attention_launch(batch_size, t, h, d)] * cfg["num_hidden_layers"]


def rope_launch(batch_size: int, n_tokens: int, heads: int, head_dim: int, itemsize: int = 2) -> tuple[float, float]:
    """(operations, bytes) of one launch of the RoPE kernel: q and k of the
    ``n_tokens`` rotated tokens read and written once (six f32 operations a
    pair), and the (n_tokens, head_dim / 2) f32 sin and cos tables read
    once. EVA02-L/448 at batch 32, bf16: 268.7 MB, 0.080 ms at 3.35 TB/s."""
    values = batch_size * n_tokens * 2 * heads * head_dim
    ops = 3.0 * values
    nbytes = 2.0 * values * itemsize + 2 * n_tokens * (head_dim // 2) * 4
    return ops, nbytes


def rope_launches(cfg: dict, batch_size: int) -> list[tuple[float, float]]:
    """The RoPE kernel's launches in one EVA02 forward: one a layer, on the
    patch tokens (all but the class token), in the activation dtype."""
    t, h, d = _shape(cfg)
    itemsize = 2 if cfg["dtype"] == "bfloat16" else 4
    return [rope_launch(batch_size, t - 1, h, d, itemsize)] * cfg["num_hidden_layers"]
