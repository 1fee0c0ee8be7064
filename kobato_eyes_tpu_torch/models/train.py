"""Tagger training / fine-tuning: the multi-label BCE step.

Counterpart of ``kobato_eyes_tpu/models/train.py`` in torch idiom: the
model holds its parameters and the step updates them in place, where the
JAX step takes and returns ``(params, opt_state)``. The optimizer is optax's
``adamw(lr, weight_decay=1e-4)`` over every parameter (no mask):
``torch.optim.AdamW`` with betas (0.9, 0.999), eps 1e-8 and the same decay
(torch's own default decay, 0.01, is not taken).

No port of a Pallas kernel has a backward, and neither has any Pallas
kernel of the JAX package (``jax.grad`` through one fails to linearize): a
model configured with the attention kernels (``attn_impl="pallas"``, ViT or
SwinV2) or the residual LayerNorm kernel (``ln_impl="pallas_residual"``)
raises here. ``"einsum"``, ``"fused"`` and ``"flash"`` (SDPA) train; the
GELU pass differentiates through its own backward kernel (``ops/gelu.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

from kobato_eyes_tpu_torch.device import resolve_device
from kobato_eyes_tpu_torch.models.preprocess import PreprocessSpec, normalize_on_device
from kobato_eyes_tpu_torch.models.vit import ViT, ViTConfig, init_vit_


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


def make_train_step(
    vit_cfg: ViTConfig | None,
    spec: PreprocessSpec,
    train_cfg: TrainConfig = TrainConfig(),
    *,
    model: Any = None,
    device=None,
) -> tuple[TrainStep, torch.optim.AdamW]:
    """Returns ``(step, optimizer)``; ``step(batch_u8, labels)`` trains
    ``step.model`` on ``device`` (default ``cuda``; raises without a GPU).

    Pass ``model`` explicitly to fine-tune any backbone (SwinV2, the CLIP
    encoder, ...) with its weights; otherwise a ViT is built from
    ``vit_cfg`` by ``_init_model``.
    """
    dev = resolve_device(device)
    if model is None:
        model = _init_model(vit_cfg)
    check_trainable(model)
    model = model.to(dev).train().requires_grad_(True)
    optimizer = make_optimizer(train_cfg, model.parameters())
    return TrainStep(model, optimizer, spec, train_cfg, dev), optimizer
