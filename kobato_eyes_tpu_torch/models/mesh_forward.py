"""The tagger's forward over a (data, model) mesh.

The JAX tagger places its parameters by ``parallel/mesh.py``'s rules and
lets GSPMD partition one jitted forward. Here the partition is written out:

* ``data``: the batch (padded to a multiple of the data axis by the caller)
  splits into one contiguous block a data row, and each row runs its own
  forward on its entries. The logits come back to the mesh's first entry in
  row order.
* ``model`` (ViT only): each model entry of a row holds a :class:`ViT` built
  with ``split`` — a run of the attention heads, of the MLP width and of the
  classes — cut from the full state dict by ``mesh.place_params``. The row's
  first entry computes what is replicated (patch embedding, LayerNorms,
  residuals, pooling) and copies each block's normalised input to the other
  entries; each entry runs the head-resident attention kernel on its own
  heads through the packed entry (``ops/attention.py``) and the product of
  its part of the out-projection, and its MLP columns up to the product of
  its part of fc2. The partial products are summed in f32 on the first
  entry in model order, rounded to the activation dtype, and the bias added
  once: the reduction that GSPMD inserts, in another order than one device
  sums, so a tensor-parallel forward is not bit-equal to one device. The
  class shards' logits are concatenated. A part whose rule does not divide
  the model axis (``mesh.shard_params``) stays whole on the first entry.

The same forward trains (``models/train.py``): the copies between entries
carry the gradients back to each shard. The replicated tensors of entries
other than a row's first are placed but never read (:meth:`MeshForward.reads`).

SwinV2 under a mesh is data parallel only: the ViT rules name no SwinV2
tensor the port could split cleanly, so each row's first entry holds a
whole replica.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from kobato_eyes_tpu_torch.models.vit import ViT, attention_residual
from kobato_eyes_tpu_torch.parallel.mesh import (
    MODEL_AXIS,
    Mesh,
    Sharding,
    gather_params,
    place_params,
    shard_params,
)


def _split(cfg, shardings: dict[str, Sharding], mesh: Mesh) -> tuple[int, int, int]:
    """Into how many model shards the heads, MLP width and classes go (1
    where their rule replicates)."""
    n = mesh.shape[MODEL_AXIS]

    def parts(names: tuple[str, ...]) -> int:
        return 1 if any(shardings[name].replicated for name in names) else n

    blocks = [f"blocks.{i}." for i in range(cfg.depth)]
    return (
        parts(tuple(b + s for b in blocks for s in ("attn.qkv.weight", "attn.qkv.bias", "attn.proj.weight"))),
        parts(tuple(b + s for b in blocks for s in ("mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight"))),
        parts(("head.weight", "head.bias")),
    )


def _reduce(parts: list[torch.Tensor], device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """Sum partial products in f32 on ``device``, in model order."""
    total = parts[0].to(device, torch.float32)
    for p in parts[1:]:
        total = total + p.to(device, torch.float32)
    return total.to(dtype)


class MeshForward:
    """``model`` (a ViT or SwinV2 with its weights) placed over ``mesh``;
    calling it maps a list of per-row image blocks to per-row logits."""

    def __init__(self, model: nn.Module, mesh: Mesh) -> None:
        self.mesh = mesh
        grid = mesh.local_devices
        state = model.state_dict()
        self.shapes = {name: tuple(t.shape) for name, t in state.items()}
        self.split, self._sharded = (1, 1, 1), set()
        if isinstance(model, ViT):
            self.num_heads = model.cfg.num_heads
            shardings = shard_params(state, mesh, num_heads=self.num_heads)
            self.split = _split(model.cfg, shardings, mesh)
            self._sharded = {name for name, s in shardings.items() if not s.replicated}
        if self.split == (1, 1, 1):
            # data parallel: a whole replica on each row's first entry
            self.rows = [[copy.deepcopy(model).to(grid[r, 0])] for r in range(grid.shape[0])]
            return
        placed = place_params(state, mesh, num_heads=self.num_heads)
        self.rows = []
        for r, row in enumerate(placed):
            shards = []
            for m, entry in enumerate(row):
                shard = ViT(model.cfg, split=self.split)
                shard.load_state_dict(entry, strict=True)
                shards.append(shard.to(grid[r, m]).eval().requires_grad_(False))
            self.rows.append(shards)

    def reads(self, m: int) -> set[str]:
        """The parameter names that the forward reads on model entry ``m``:
        all on a row's first entry, the sharded ones elsewhere."""
        names = set(self.shapes)
        return names if m == 0 else names & self._sharded

    def gather(self, rows: list[list[dict[str, torch.Tensor]]]) -> dict[str, torch.Tensor]:
        """Whole tensors, on the mesh's first entry, from per-entry dicts laid
        out as :attr:`rows` (each shard's parameters, or their gradients)."""
        if self.split == (1, 1, 1):
            return dict(rows[0][0])
        return gather_params(rows, self.mesh, num_heads=self.num_heads, shapes=self.shapes)

    def state_dict(self) -> dict[str, torch.Tensor]:
        """The whole model's state (timm names), gathered from the shards."""
        return self.gather([[shard.state_dict() for shard in row] for row in self.rows])

    def __call__(self, blocks: list[torch.Tensor]) -> list[torch.Tensor]:
        """Per data row: (b, S, S, 3) normalised images on the row's first
        entry -> (b, C) f32 logits there."""
        return [self.row(r, x) for r, x in enumerate(blocks)]

    def row(self, r: int, x: torch.Tensor) -> torch.Tensor:
        """Data row ``r``'s forward of its block ``x``."""
        shards = self.rows[r]
        if self.split == (1, 1, 1):
            return shards[0](x)
        devs = list(self.mesh.local_devices[r])
        s0 = shards[0]
        dtype = s0.cfg.dtype
        split_attn, split_mlp, split_head = (n > 1 for n in self.split)
        h = s0.embed(x)
        for i, block in enumerate(s0.blocks):
            a = block.norm1(h)
            if split_attn:
                parts = [s.blocks[i].attn.proj.product(s.blocks[i].attn.heads_out(a.to(d)))
                         for s, d in zip(shards, devs)]
                res = attention_residual(h, _reduce(parts, x.device, dtype) + block.attn.proj.bias.to(dtype))
            else:
                res = attention_residual(h, block.attn(a))
            h = res.to(dtype)
            a = block.norm2(res)
            if split_mlp:
                parts = [s.blocks[i].mlp.fc2.product(s.blocks[i].mlp.hidden(a.to(d)))
                         for s, d in zip(shards, devs)]
                h = h + (_reduce(parts, x.device, dtype) + block.mlp.fc2.bias.to(dtype))
            else:
                h = h + block.mlp(a)
        feat = s0.pool(h)
        if split_head:
            return torch.cat([s.head(feat.to(d)).to(x.device) for s, d in zip(shards, devs)], dim=-1).float()
        return s0.head(feat).float()
