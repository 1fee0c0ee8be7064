"""WD14 SwinV2-B forward, written plainly from the published model (timm's
``SwinTransformerV2``: conv patch embedding and norm; blocks of scaled cosine
window attention with the clamped logit scale and the log-spaced continuous
position bias, shifted windows with the -100 mask, residual post-norm; patch
merging; mean pool into a linear head) in float32.

Input as ``reference.vit``. Departure from timm: the qkv bias has a k third,
taken from the weights (timm holds it at zero; the weights here hold zeros
there too). ``precision="fp8"`` rounds the operands of every product outside
the position-bias MLP through fp8 (the control).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ketbench.reference.precision import exact_float32, operand_rounding


@torch.no_grad()
def swin_logits(state: dict, cfg: dict, images: torch.Tensor, *, precision: str = "float32", chunk: int = 8) -> torch.Tensor:
    """(B, num_labels) float32 logits."""
    with exact_float32():
        return torch.cat([_forward(state, cfg, images[i : i + chunk], operand_rounding(precision))
                          for i in range(0, images.shape[0], chunk)])


def _relative_coords(w: int) -> np.ndarray:
    """(w*w, w*w, 2): each pair's offset, scaled to [-8, 8] and log-spaced."""
    grid = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"), -1).reshape(-1, 2)
    rel = (grid[:, None, :] - grid[None, :, :]).astype(np.float64) / (w - 1) * 8.0
    return (np.sign(rel) * np.log2(np.abs(rel) + 1.0) / np.log2(8.0)).astype(np.float32)


def _shift_mask(grid: int, w: int, s: int) -> np.ndarray:
    """(nW, w*w, w*w): -100 between tokens from different regions of the rolled map."""
    region = np.zeros((grid, grid), dtype=np.int64)
    cuts = (slice(0, grid - w), slice(grid - w, grid - s), slice(grid - s, grid))
    label = 0
    for rows in cuts:
        for cols in cuts:
            region[rows, cols] = label
            label += 1
    win = region.reshape(grid // w, w, grid // w, w).transpose(0, 2, 1, 3).reshape(-1, w * w)
    return np.where(win[:, :, None] != win[:, None, :], -100.0, 0.0).astype(np.float32)


def _forward(state: dict, cfg: dict, images: torch.Tensor, rnd) -> torch.Tensor:
    eps = cfg["layer_norm_eps"]
    w = cfg["window_size"]
    n = w * w
    dev = images.device

    def linear(x, name, bias=True):
        y = rnd(x) @ rnd(state[name + ".weight"]).t()
        return y + state[name + ".bias"] if bias else y

    def norm(x, name):
        return F.layer_norm(x, (x.shape[-1],), state[name + ".weight"], state[name + ".bias"], eps)

    rel = torch.from_numpy(_relative_coords(w)).to(dev)
    x = images.float().flip(-1).permute(0, 3, 1, 2)
    x = F.conv2d(rnd(x), rnd(state["patch_embed.proj.weight"]), state["patch_embed.proj.bias"],
                 stride=cfg["patch_size"]).permute(0, 2, 3, 1)
    x = norm(x, "patch_embed.norm")
    for s, depth in enumerate(cfg["depths"]):
        if s > 0:
            pre = f"layers.{s}.downsample"
            x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
            x = norm(linear(x, pre + ".reduction", bias=False), pre + ".norm")
        b, g, _, c = x.shape
        heads = cfg["num_heads"][s]
        hd = c // heads
        nw = (g // w) ** 2
        for i in range(depth):
            pre = f"layers.{s}.blocks.{i}."
            shift = w // 2 if i % 2 else 0
            shortcut = x
            if shift:
                x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
            win = x.reshape(b, g // w, w, g // w, w, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, n, c)
            bias = torch.cat([state[pre + "attn.q_bias"], state[pre + "attn.k_bias"], state[pre + "attn.v_bias"]])
            qkv = (rnd(win) @ rnd(state[pre + "attn.qkv.weight"]).t() + bias).reshape(-1, n, 3, heads, hd)
            q, k, v = qkv.permute(2, 0, 3, 1, 4)
            logits = rnd(F.normalize(q, dim=-1)) @ rnd(F.normalize(k, dim=-1)).transpose(-1, -2)
            scale = torch.exp(torch.clamp(state[pre + "attn.logit_scale"], max=math.log(100.0)))
            hidden = torch.relu(rel @ state[pre + "attn.cpb_mlp.0.weight"].t() + state[pre + "attn.cpb_mlp.0.bias"])
            cpb = 16.0 * torch.sigmoid(hidden @ state[pre + "attn.cpb_mlp.2.weight"].t()).permute(2, 0, 1)
            logits = logits * scale + cpb
            if shift:
                mask = torch.from_numpy(_shift_mask(g, w, shift)).to(dev)
                logits = (logits.view(b, nw, heads, n, n) + mask[None, :, None]).view(-1, heads, n, n)
            out = rnd(torch.softmax(logits, dim=-1)) @ rnd(v)
            out = linear(out.transpose(1, 2).reshape(-1, n, c), pre + "attn.proj")
            out = out.reshape(b, g // w, g // w, w, w, c).permute(0, 1, 3, 2, 4, 5).reshape(b, g, g, c)
            if shift:
                out = torch.roll(out, shifts=(shift, shift), dims=(1, 2))
            x = shortcut + norm(out, pre + "norm1")
            h = linear(F.gelu(linear(x, pre + "mlp.fc1")), pre + "mlp.fc2")
            x = x + norm(h, pre + "norm2")
    feat = norm(x, "norm").mean(dim=(1, 2))
    return linear(feat, "head.fc")
