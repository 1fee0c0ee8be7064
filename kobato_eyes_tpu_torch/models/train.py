"""Tagger training / fine-tuning: the multi-label BCE step.

Counterpart of ``kobato_eyes_tpu/models/train.py`` in torch idiom: the
model holds its parameters and the step updates them in place, where the
JAX step takes and returns ``(params, opt_state)``. The optimizer is optax's
``adamw(lr, weight_decay=1e-4)`` over every parameter (no mask):
``torch.optim.AdamW`` with betas (0.9, 0.999), eps 1e-8 and the same decay
(torch's own default decay, 0.01, is not taken).

``attn_impl="flash"`` trains through its own backward kernels, as the JAX
package's Pallas flash attention does through its ``custom_vjp``: the
forward kernel of ``ops/flash_attention.py`` saves the row max and sum, and
the dK/dV and dQ kernels run in the backward. The other Pallas kernels of
the JAX package have no backward (``jax.grad`` through one fails to
linearize), and neither have their ports: a model configured with the
head-resident or window attention kernel (``attn_impl="pallas"``, ViT or
SwinV2) or the residual LayerNorm kernel (``ln_impl="pallas_residual"``)
raises here. ``"einsum"``, ``"fused"`` (SDPA) and ``"flash"`` train; the
GELU pass differentiates through its own backward kernel (``ops/gelu.py``).

Over a (data, model) mesh (``parallel/mesh.py``) the JAX step is one ``jit``
that GSPMD partitions; :class:`MeshTrainStep` writes the partition out on
``models/mesh_forward.MeshForward``, the forward the sharded tagger runs:

* the batch splits into one contiguous block a data row (it must divide the
  data axis: padding would change the mean); each row takes its block's
  mean BCE and backward;
* the gradient of every parameter a row holds is summed over the rows in
  f32, in row order, and divided by the number of rows: the gradient of the
  whole batch's mean, which every row then holds;
* each shard of each row has its own AdamW (``make_optimizer``) over the
  parameters the forward reads on it (AdamW is elementwise, so sharded
  moments are the one-device moments' slices); a replicated copy that no
  forward reads gets no gradient and is never stepped or read back.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

from kobato_eyes_tpu_torch.device import resolve_device
from kobato_eyes_tpu_torch.models.mesh_forward import MeshForward
from kobato_eyes_tpu_torch.models.preprocess import PreprocessSpec, normalize_on_device
from kobato_eyes_tpu_torch.models.vit import ViT, ViTConfig, init_vit_
from kobato_eyes_tpu_torch.parallel.mesh import Mesh, shard_batch


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 1e-4
    label_smoothing: float = 0.0


def make_optimizer(cfg: TrainConfig, params) -> torch.optim.AdamW:
    """optax ``adamw(lr, weight_decay=cfg.weight_decay)`` over ``params``."""
    return torch.optim.AdamW(
        params, lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=cfg.weight_decay,
    )


def bce_loss(logits: torch.Tensor, labels: torch.Tensor, smoothing: float = 0.0) -> torch.Tensor:
    """Mean sigmoid binary cross-entropy over (B, C) multi-hot labels (optax's
    ``sigmoid_binary_cross_entropy``: ``-y log σ(x) - (1 - y) log σ(-x)``)."""
    labels = labels.to(torch.float32)
    if smoothing > 0.0:
        labels = labels * (1.0 - smoothing) + 0.5 * smoothing
    logits = logits.to(torch.float32)
    return (-labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)).mean()


def check_trainable(model: Any) -> None:
    """Raise if ``model`` is configured with a CUDA kernel that has no
    backward (the attention kernels, the residual LayerNorm kernel)."""
    cfg = getattr(model, "cfg", None)
    if getattr(cfg, "attn_impl", None) == "pallas":
        raise ValueError(
            "attn_impl='pallas' (the hand-written attention kernel) has no backward; "
            "train with attn_impl='einsum', 'fused' or 'flash'"
        )
    if getattr(cfg, "ln_impl", None) == "pallas_residual":
        raise ValueError(
            "ln_impl='pallas_residual' (the residual LayerNorm kernel) has no backward; "
            "train with ln_impl='xla'"
        )


def _init_model(cfg: ViTConfig) -> ViT:
    """The trainer's initial weights: the port's seeded init (the JAX package
    draws flax's ``init_params(cfg, seed=0)``, which torch cannot reproduce)."""
    return init_vit_(ViT(cfg), torch.Generator().manual_seed(0))


class TrainStep:
    """``step(batch_u8, labels) -> loss``: normalize on the device, forward,
    BCE, backward and one AdamW update of ``model`` in place. The loss comes
    back as a 0-d f32 tensor on the device (reading it waits for the step)."""

    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 spec: PreprocessSpec, train_cfg: TrainConfig, device: torch.device) -> None:
        self.model = model
        self.optimizer = optimizer
        self.spec = spec
        self.train_cfg = train_cfg
        self.device = device

    def loss(self, batch_u8, labels) -> torch.Tensor:
        """The forward and the BCE loss of one batch, graph kept for backward."""
        batch_u8 = torch.as_tensor(batch_u8).to(self.device)
        labels = torch.as_tensor(labels).to(self.device)
        logits = self.model(normalize_on_device(batch_u8, self.spec))
        return bce_loss(logits, labels, self.train_cfg.label_smoothing)

    def __call__(self, batch_u8, labels) -> torch.Tensor:
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(batch_u8, labels)
        loss.backward()
        self.optimizer.step()
        return loss.detach()


class MeshTrainStep:
    """``step(batch_u8, labels) -> loss`` over a mesh: ``forward`` (a
    :class:`MeshForward` of the model) holds the shards and ``optimizers[r][m]``
    entry (r, m)'s AdamW. The loss, the mean of the rows' losses in row
    order, comes back as a 0-d f32 tensor on the mesh's first entry."""

    def __init__(self, forward: MeshForward, spec: PreprocessSpec, train_cfg: TrainConfig) -> None:
        self.forward = forward
        self.mesh = forward.mesh
        self.spec = spec
        self.train_cfg = train_cfg
        self.device = self.mesh.local_devices[0, 0]
        self.params = []  # params[r][m]: the (name, parameter) pairs entry (r, m) reads
        for row in forward.rows:
            self.params.append([])
            for m, shard in enumerate(row):
                shard.train()
                reads = forward.reads(m)
                for name, p in shard.named_parameters():
                    p.requires_grad_(name in reads)
                self.params[-1].append([(name, p) for name, p in shard.named_parameters() if name in reads])
        self.optimizers = [[make_optimizer(train_cfg, [p for _, p in entry]) for entry in row]
                           for row in self.params]

    def __call__(self, batch_u8, labels) -> torch.Tensor:
        xs = shard_batch(torch.as_tensor(batch_u8), self.mesh)
        ys = shard_batch(torch.as_tensor(labels), self.mesh)
        for row in self.optimizers:
            for opt in row:
                opt.zero_grad(set_to_none=True)
        losses = []
        for r, (x, y) in enumerate(zip(xs, ys)):
            logits = self.forward.row(r, normalize_on_device(x, self.spec))
            loss = bce_loss(logits, y, self.train_cfg.label_smoothing)
            loss.backward()
            losses.append(loss.detach())
        self._average_gradients()
        for row in self.optimizers:
            for opt in row:
                opt.step()
        total = losses[0].to(self.device)
        for loss in losses[1:]:
            total = total + loss.to(self.device)
        return total / len(losses)

    @torch.no_grad()
    def _average_gradients(self) -> None:
        """Each parameter's gradient summed over the data rows in f32, in row
        order, divided by the rows, and copied back into every row's."""
        rows = len(self.params)
        for m, entry in enumerate(self.params[0]):
            for i, (_, p) in enumerate(entry):
                total = p.grad.to(torch.float32, copy=True)
                for row in self.params[1:]:
                    total += row[m][i][1].grad.to(total.device, torch.float32)
                total /= rows
                for row in self.params:
                    row[m][i][1].grad.copy_(total)

    def state_dict(self) -> dict[str, torch.Tensor]:
        """The whole model's state (timm names) on the mesh's first entry, for
        ``models/tagger.save_checkpoint``."""
        return self.forward.state_dict()

    def gradients(self) -> dict[str, torch.Tensor]:
        """The whole model's gradients of the last step, gathered as
        :meth:`state_dict` (after the average over the data rows)."""
        return self.forward.gather([[{name: p.grad for name, p in entry} for entry in row]
                                    for row in self.params])


def make_train_step(
    vit_cfg: ViTConfig | None,
    spec: PreprocessSpec,
    train_cfg: TrainConfig = TrainConfig(),
    *,
    model: Any = None,
    device=None,
    mesh: Mesh | None = None,
) -> tuple[TrainStep, torch.optim.AdamW] | tuple[MeshTrainStep, list[list[torch.optim.AdamW]]]:
    """Returns ``(step, optimizer)``; ``step(batch_u8, labels)`` trains
    ``step.model`` on ``device`` (default ``cuda``; raises without a GPU).

    Pass ``model`` explicitly to fine-tune any backbone (SwinV2, the CLIP
    encoder, ...) with its weights; otherwise a ViT is built from
    ``vit_cfg`` by ``_init_model``.

    With ``mesh`` (this process's entries; not with ``device``) the step is a
    :class:`MeshTrainStep` over copies of ``model`` placed on the mesh (ViT:
    data x model; other backbones: data parallel), and the optimizers come
    back as its grid ``optimizers[r][m]``.
    """
    if mesh is not None and device is not None:
        raise ValueError("pass mesh= or device=, not both: a mesh step runs on the mesh's entries")
    dev = None if mesh is not None else resolve_device(device)
    if model is None:
        model = _init_model(vit_cfg)
    check_trainable(model)
    if mesh is not None:
        step = MeshTrainStep(MeshForward(model, mesh), spec, train_cfg)
        return step, step.optimizers
    model = model.to(dev).train().requires_grad_(True)
    optimizer = make_optimizer(train_cfg, model.parameters())
    return TrainStep(model, optimizer, spec, train_cfg, dev), optimizer
