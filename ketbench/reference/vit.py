"""WD14 ViT-B/16 forward, written plainly from the published model (timm's
``VisionTransformer``: conv patch embedding, class token, pre-norm blocks,
erf GELU, the class token's final norm into a linear head) in float32.

Input: (B, S, S, 3) uint8 RGB letterboxed pictures; WD14 models read BGR in
0..255, unnormalised. Departure from timm: LayerNorm's epsilon comes from the
configuration (``layer_norm_eps``). ``precision="fp8"`` rounds every
product's operands through fp8 (the control).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ketbench.reference.precision import exact_float32, operand_rounding


@torch.no_grad()
def vit_logits(state: dict, cfg: dict, images: torch.Tensor, *, precision: str = "float32", chunk: int = 16) -> torch.Tensor:
    """(B, num_labels) float32 logits."""
    with exact_float32():
        return torch.cat([_forward(state, cfg, images[i : i + chunk], operand_rounding(precision))
                          for i in range(0, images.shape[0], chunk)])


def _forward(state: dict, cfg: dict, images: torch.Tensor, rnd) -> torch.Tensor:
    eps = cfg["layer_norm_eps"]
    heads = cfg["num_attention_heads"]
    width = cfg["hidden_size"]
    hd = width // heads

    def linear(x, name):
        return rnd(x) @ rnd(state[name + ".weight"]).t() + state[name + ".bias"]

    def norm(x, name):
        return F.layer_norm(x, (width,), state[name + ".weight"], state[name + ".bias"], eps)

    b = images.shape[0]
    x = images.float().flip(-1).permute(0, 3, 1, 2)  # BGR, NCHW
    x = F.conv2d(rnd(x), rnd(state["patch_embed.proj.weight"]), state["patch_embed.proj.bias"],
                 stride=cfg["patch_size"])
    x = x.flatten(2).transpose(1, 2)
    x = torch.cat([state["cls_token"].expand(b, -1, -1), x], dim=1) + state["pos_embed"]
    t = x.shape[1]
    for i in range(cfg["num_hidden_layers"]):
        pre = f"blocks.{i}."
        qkv = linear(norm(x, pre + "norm1"), pre + "attn.qkv")
        q, k, v = qkv.view(b, t, 3, heads, hd).permute(2, 0, 3, 1, 4)
        attn = torch.softmax((rnd(q) @ rnd(k).transpose(-1, -2)) * hd**-0.5, dim=-1)
        out = (rnd(attn) @ rnd(v)).transpose(1, 2).reshape(b, t, width)
        x = x + linear(out, pre + "attn.proj")
        h = F.gelu(linear(norm(x, pre + "norm2"), pre + "mlp.fc1"))
        x = x + linear(h, pre + "mlp.fc2")
    feat = norm(x, "norm")[:, 0]
    return linear(feat, "head")
