"""The yardstick's arithmetic: the card's peaks, the forwards' operations
and the hand-written attention kernels' operations and bytes.

``vit_forward_flops`` and ``swin_forward_flops`` are frozen copies of the
port's (``models/vit.py``, ``models/swin.py``): analytic matmul FLOPs, two a
multiply-add, norms and the CPB MLP left out.
"""

from __future__ import annotations

# Published dense peaks by ``torch.cuda.get_device_name()``: bf16 tensor
# FLOP/s and HBM bytes/s (NVIDIA's H100 data sheet; the SXM part at 700 W).
PEAKS: dict[str, tuple[float, float]] = {
    "NVIDIA H100 80GB HBM3": (989e12, 3.35e12),
    "NVIDIA H100 PCIe": (756e12, 2.0e12),
    "NVIDIA H100 NVL": (835e12, 3.9e12),
}


def peaks(device_name: str) -> tuple[float, float] | None:
    """(bf16 FLOP/s, bytes/s) of the card, None for a card not in the table."""
    return PEAKS.get(device_name)


def vit_forward_flops(cfg: dict, batch_size: int, *, with_head: bool = True) -> float:
    d, p = cfg["hidden_size"], cfg["patch_size"]
    n = (cfg["image_size"] // p) ** 2
    t = n + 1
    patch = 2 * n * (p**2 * 3) * d
    per_layer = (
        2 * t * d * 3 * d
        + 2 * 2 * t * t * d
        + 2 * t * d * d
        + 2 * 2 * t * d * cfg["intermediate_size"]
    )
    head = 2 * d * cfg["num_labels"] if with_head else 0
    return float(batch_size) * (patch + cfg["num_hidden_layers"] * per_layer + head)


def swin_forward_flops(cfg: dict, batch_size: int, *, with_head: bool = True) -> float:
    p, e, w = cfg["patch_size"], cfg["embed_dim"], cfg["window_size"]
    stages = len(cfg["depths"])
    t0 = (cfg["image_size"] // p) ** 2
    total = 2.0 * t0 * (p * p * 3) * e
    for s, depth in enumerate(cfg["depths"]):
        c = e * 2**s
        t = (cfg["image_size"] // p // 2**s) ** 2
        mlp = cfg["mlp_ratio"] * c
        per_block = 2 * t * c * 3 * c + 4 * t * w**2 * c + 2 * t * c * c + 2 * 2 * t * c * mlp
        total += depth * per_block
        if s < stages - 1:
            total += 2 * (t / 4) * (4 * c) * (2 * c)
    if with_head:
        total += 2 * e * 2 ** (stages - 1) * cfg["num_labels"]
    return float(batch_size) * total


def forward_flops(cfg: dict, batch_size: int) -> float:
    if cfg["arch"] == "vit":
        return vit_forward_flops(cfg, batch_size)
    return swin_forward_flops(cfg, batch_size)


def head_attention_launch(b: int, t: int, h: int, d: int, itemsize: int = 2) -> tuple[float, float]:
    """(operations, bytes) of one launch of the head-resident attention
    kernel over packed (B, T, 3, H, D) q, k, v: two products of 2 T^2 D a
    head, q, k and v read once and the output written once."""
    ops = 4.0 * b * h * t * t * d
    nbytes = 4.0 * b * t * h * d * itemsize
    return ops, nbytes


def vit_attention_launches(cfg: dict, batch_size: int) -> list[tuple[float, float]]:
    """Kernel 1's launches in one ViT forward: one a layer."""
    t = (cfg["image_size"] // cfg["patch_size"]) ** 2 + 1
    h = cfg["num_attention_heads"]
    launch = head_attention_launch(batch_size, t, h, cfg["hidden_size"] // h)
    return [launch] * cfg["num_hidden_layers"]


def window_attention_launch(
    b: int, grid: int, window: int, heads: int, channels: int, shifted: bool, itemsize: int = 2,
) -> tuple[float, float]:
    """(operations, bytes) of one launch of the window cosine attention
    kernel over a (B, grid, grid, C) stage: QK and PV in every window; the
    packed qkv read and the output written once, the f32 CPB bias (H, n, n)
    and logit scales, and the shift mask (nW, n, n) in a shifted block."""
    n = window * window
    tokens = b * grid * grid
    ops = 4.0 * tokens * n * channels
    nbytes = tokens * 4 * channels * itemsize + heads * n * n * 4 + heads * 4
    if shifted:
        nbytes += (grid // window) ** 2 * n * n * 4
    return ops, float(nbytes)


def swin_attention_launches(cfg: dict, batch_size: int) -> list[tuple[float, float]]:
    """Kernel 3's launches in one SwinV2 forward: one a block, odd blocks shifted."""
    launches = []
    for s, depth in enumerate(cfg["depths"]):
        grid = cfg["image_size"] // cfg["patch_size"] // 2**s
        c = cfg["embed_dim"] * 2**s
        for i in range(depth):
            launches.append(window_attention_launch(
                batch_size, grid, cfg["window_size"], cfg["num_heads"][s], c, shifted=i % 2 == 1,
            ))
    return launches


def bound_seconds(launches: list[tuple[float, float]], device_name: str) -> float | None:
    """The least time the card could take for ``launches``: each launch's
    larger of operations over peak FLOP/s and bytes over peak bytes/s."""
    pk = peaks(device_name)
    if pk is None:
        return None
    flops, bw = pk
    return sum(max(ops / flops, nbytes / bw) for ops, nbytes in launches)
