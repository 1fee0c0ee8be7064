"""PixAI Tagger v0.9's forward, written plainly from its published backbone
(timm's ``eva02_large_patch14_448`` as ``hf_hub:SmilingWolf/wd-eva02-large-
tagger-v3``, which PixAI's inference code builds, with a new linear head) in
float32:

* conv patch embedding (with bias), class token, absolute position embedding;
* pre-norm blocks: ``x + Attn(LN1(x))``, ``x + SwiGLU(LN2(x))``, no layer scale;
* attention with separate q (bias), k (no bias) and v (bias) projections; 2D
  RoPE (timm's ``RotaryEmbeddingCat``, ``in_pixels=False``, scaled to
  ``ref_feat_shape``) on q and k of the patch tokens, the class token left
  as it is; ``softmax(q k^T / sqrt(D)) v``; ``proj``;
* SwiGLU: ``fc2(LN_h(SiLU(fc1_g(x)) * fc1_x(x)))``;
* the mean over the patch tokens, ``fc_norm``, the linear head.

Input: (B, S, S, 3) uint8 RGB pictures cut as ``reference.pixai_pictures``
cuts them, normalised here with the configuration's mean and std.

Departures from timm: the RoPE table is evaluated in float64 and rounded to
float32 (timm evaluates it in float32; the two differ by about 1e-6);
LayerNorm's epsilon comes from the configuration (``layer_norm_eps``, timm's
1e-6). The pool is timm's ``global_pool="avg"`` with ``fc_norm``, assumed for
the wd-eva02 tagger.
``precision="fp8"`` rounds the operands of every product through fp8 (the
control). Pictures are computed ``chunk`` at a time.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ketbench.reference.precision import exact_float32, operand_rounding


@torch.no_grad()
def eva02_logits(state: dict, cfg: dict, images: torch.Tensor, *, precision: str = "float32", chunk: int = 16) -> torch.Tensor:
    """(B, num_labels) float32 logits."""
    sin, cos = rope_tables(cfg, images.device)
    with exact_float32():
        return torch.cat([_forward(state, cfg, images[i : i + chunk], sin, cos, operand_rounding(precision))
                          for i in range(0, images.shape[0], chunk)])


def rope_tables(cfg: dict, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos), each (patches, head_dim) float32: ``[y b_0 .. y b_{n-1},
    x b_0 .. x b_{n-1}]`` with bands ``b_m = T^(-m/n)``, n = head_dim / 4, each
    angle repeated twice in place; the patch at row i and column j sits at
    ``y = i * ref / grid``, ``x = j * ref / grid``."""
    hd = cfg["hidden_size"] // cfg["num_attention_heads"]
    n = hd // 4
    grid = cfg["image_size"] // cfg["patch_size"]
    bands = 1.0 / cfg["rope_theta"] ** (torch.arange(n, dtype=torch.float64) / n)
    t = torch.arange(grid, dtype=torch.float64) / grid * cfg["rope_ref_feat_shape"]
    yy, xx = torch.meshgrid(t, t, indexing="ij")
    pos = (torch.stack([yy, xx], dim=-1)[..., None] * bands).reshape(grid * grid, 2 * n)
    return (pos.sin().float().repeat_interleave(2, -1).to(device),
            pos.cos().float().repeat_interleave(2, -1).to(device))


def rotate(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """timm's ``apply_rot_embed_cat``: ``x cos + rot(x) sin``, where rot turns
    each pair (a, b) into (-b, a)."""
    rot = torch.stack([-x[..., 1::2], x[..., 0::2]], dim=-1).reshape(x.shape)
    return x * cos + rot * sin


def _forward(state: dict, cfg: dict, images: torch.Tensor, sin, cos, rnd) -> torch.Tensor:
    eps = cfg["layer_norm_eps"]
    heads = cfg["num_attention_heads"]
    width = cfg["hidden_size"]
    hd = width // heads
    mean = torch.tensor(cfg["mean"], dtype=torch.float32, device=images.device)
    std = torch.tensor(cfg["std"], dtype=torch.float32, device=images.device)

    def linear(x, name, bias=True):
        y = rnd(x) @ rnd(state[name + ".weight"]).t()
        return y + state[name + ".bias"] if bias else y

    def norm(x, name):
        return F.layer_norm(x, (x.shape[-1],), state[name + ".weight"], state[name + ".bias"], eps)

    b = images.shape[0]
    x = ((images.float() / 255.0 - mean) / std).permute(0, 3, 1, 2)
    x = F.conv2d(rnd(x), rnd(state["patch_embed.proj.weight"]), state["patch_embed.proj.bias"],
                 stride=cfg["patch_size"])
    x = x.flatten(2).transpose(1, 2)
    x = torch.cat([state["cls_token"].expand(b, -1, -1), x], dim=1) + state["pos_embed"]
    t = x.shape[1]
    for i in range(cfg["num_hidden_layers"]):
        pre = f"blocks.{i}."
        h = norm(x, pre + "norm1")
        q, k, v = (linear(h, pre + f"attn.{p}_proj", bias=p != "k").view(b, t, heads, hd).transpose(1, 2)
                   for p in "qkv")
        q = torch.cat([q[:, :, :1], rotate(q[:, :, 1:], sin, cos)], dim=2)
        k = torch.cat([k[:, :, :1], rotate(k[:, :, 1:], sin, cos)], dim=2)
        attn = torch.softmax((rnd(q) @ rnd(k).transpose(-1, -2)) * hd**-0.5, dim=-1)
        out = (rnd(attn) @ rnd(v)).transpose(1, 2).reshape(b, t, width)
        x = x + linear(out, pre + "attn.proj")
        h = norm(x, pre + "norm2")
        h = F.silu(linear(h, pre + "mlp.fc1_g")) * linear(h, pre + "mlp.fc1_x")
        x = x + linear(norm(h, pre + "mlp.norm"), pre + "mlp.fc2")
    feat = norm(x[:, 1:].mean(dim=1), "fc_norm")
    return linear(feat, "head")
