"""CLIP-style image embedder: ViT backbone + projection head, L2-normalized.

Counterpart of ``kobato_eyes_tpu/index/embedder.py``: the embedding pass
that feeds the ANN index. Weights are a state dict (the port's ViT under
``vit.`` plus ``proj.weight``; ``models/import_weights`` converts OpenAI /
open_clip towers and the JAX package's tree) or a random init from a seeded
``torch.Generator``. The geometry (224 px, patch 32, 512-d projection) is
the CLIP ViT-B/32 class.
"""

from __future__ import annotations

import logging
import math
from pathlib import Path
from typing import Any, Mapping, Sequence

import numpy as np
import torch
from torch import nn

from kobato_eyes_tpu_torch.device import resolve_device
from kobato_eyes_tpu_torch.models.preprocess import (
    CLIP_MEAN,
    CLIP_STD,
    PreprocessSpec,
    letterbox_square_rgb,
    normalize_on_device,
    shortside_centercrop_rgb,
)
from kobato_eyes_tpu_torch.models.vit import Linear, ViT, ViTConfig, init_vit_, vit_config

logger = logging.getLogger(__name__)


def embedder_config(
    preset: str, image_size: int, patch_size: int, embed_dim: int, clip_variant: str | None
) -> ViTConfig:
    """The embedder's ViT config. A named CLIP variant sets the visual
    tower's geometry: ln_pre, no patch bias, QuickGELU for OpenAI weights."""
    variant_kw: dict[str, Any] = {}
    if clip_variant is not None:
        if clip_variant not in ("openai", "open_clip"):
            raise ValueError(f"unknown clip_variant {clip_variant!r}")
        variant_kw = dict(
            ln_pre=True,
            patch_bias=False,
            act="quick_gelu" if clip_variant == "openai" else "gelu",
        )
    return vit_config(
        preset, image_size=image_size, patch_size=patch_size, num_classes=embed_dim, **variant_kw,
    )


class ClipImageEncoder(nn.Module):
    """ViT features -> bias-free projection in ``cfg.dtype`` -> f32 -> unit
    length (``max(norm, 1e-6)``, as the JAX module divides)."""

    def __init__(self, cfg: ViTConfig, embed_dim: int = 512) -> None:
        super().__init__()
        self.vit = ViT(cfg)
        del self.vit.head  # features_only: the tower has no classifier
        self.proj = Linear(cfg.hidden_dim, embed_dim, cfg, bias=False)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        proj = self.proj(self.vit(images, features_only=True)).float()
        return proj / torch.linalg.vector_norm(proj, dim=-1, keepdim=True).clamp_min(1e-6)


class ImageEmbedder:
    """Host wrapper: prepare uint8 batches, run the embedding pass on
    ``device`` (default ``cuda``; raises without a GPU)."""

    def __init__(
        self,
        *,
        preset: str = "base",
        image_size: int = 224,
        patch_size: int = 32,
        embed_dim: int = 512,
        state_dict: Mapping[str, torch.Tensor] | None = None,
        checkpoint_path: str | Path | None = None,
        clip_variant: str | None = None,  # "openai" | "open_clip" | None
        seed: int = 0,
        derive_from: int | None = None,
        device: str | torch.device | None = None,
    ) -> None:
        # Derived prep: accept the TAGGER's prepared tensor (white-letterbox
        # square at `derive_from` px, uint8) and downsample to `image_size`
        # on the device with an f×f mean pool (f = derive_from / image_size;
        # mean pooling is the BOX/AREA resample the host letterbox uses for
        # downscales). The index pipeline then chains the embedding forward
        # onto the tagger's uploaded pixels: one decode, one upload. Query-time
        # prepare applies the SAME letterbox so index and query vectors share
        # one space; the prep is recorded in the catalog meta table
        # (db.repository.ensure_embed_prep).
        if derive_from is not None:
            if derive_from % image_size != 0 or derive_from < image_size:
                raise ValueError(
                    f"derive_from={derive_from} must be a multiple of image_size={image_size}"
                )
        if checkpoint_path is not None:
            raise NotImplementedError(
                "orbax checkpoint loading comes with the checkpoint IO slice of the port; "
                "use ImageEmbedder.from_clip_checkpoint for a .pt/.safetensors CLIP tower"
            )
        self.derive_from = derive_from
        self.device = resolve_device(device)
        self.cfg = embedder_config(preset, image_size, patch_size, embed_dim, clip_variant)
        self.embed_dim = embed_dim
        # CLIP's own mean/std statistics for a named variant
        self.spec = (
            PreprocessSpec(mode="pixai", size=image_size, mean=CLIP_MEAN, std=CLIP_STD)
            if clip_variant
            else PreprocessSpec(mode="pixai", size=image_size)  # ImageNet mean/std
        )
        model = ClipImageEncoder(self.cfg, embed_dim=embed_dim)
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        else:
            logger.info("embedder: random-init weights (%s, %dpx)", preset, image_size)
            init_encoder_(model, torch.Generator().manual_seed(seed))
        self._model = model.to(self.device).eval().requires_grad_(False)

    @classmethod
    def from_clip_checkpoint(
        cls,
        state_dict_path: str | Path,
        *,
        clip_variant: str = "openai",
        preset: str = "base",
        image_size: int = 224,
        patch_size: int = 32,
        embed_dim: int = 512,
        device: str | torch.device | None = None,
    ) -> "ImageEmbedder":
        """Build from a CLIP checkpoint (.pt/.safetensors), routed through
        ``import_torch_checkpoint`` so naming drift fails with every key
        named instead of a deep KeyError."""
        from kobato_eyes_tpu_torch.models.import_weights import import_torch_checkpoint

        cfg = embedder_config(preset, image_size, patch_size, embed_dim, clip_variant)
        return cls(
            preset=preset, image_size=image_size, patch_size=patch_size,
            embed_dim=embed_dim, clip_variant=clip_variant, device=device,
            state_dict=import_torch_checkpoint(state_dict_path, cfg),
        )

    @property
    def prep_key(self) -> str:
        """Stable id of the prepared-tensor geometry feeding ``_embed``,
        stored in the catalog meta table so query-time embedders rebuild the
        index-time prep (``db.repository.ensure_embed_prep``)."""
        if self.derive_from is not None:
            return f"lb{self.derive_from}->mean->{self.cfg.image_size}"
        return f"cc{self.cfg.image_size}"

    @property
    def model_key(self) -> str:
        """Catalog ``embeddings.model`` key (prep provenance lives in meta)."""
        return "clip-vit"

    def accepts_prepared(self, side: int, mode: str) -> bool:
        """True when a tagger's prepared (side×side, ``mode`` geometry) batch
        is exactly this embedder's expected input — the fusion precondition."""
        if self.derive_from is not None:
            return mode == "wd14" and side == self.derive_from
        return False

    def prepare_batch_from_rgb(self, images: Sequence[np.ndarray]) -> np.ndarray:
        if self.derive_from is not None:
            return np.stack([letterbox_square_rgb(a, self.derive_from) for a in images])
        return np.stack([shortside_centercrop_rgb(a, self.cfg.image_size) for a in images])

    def _embed(self, batch: torch.Tensor) -> torch.Tensor:
        x = batch
        if self.derive_from is not None:
            f = self.derive_from // self.cfg.image_size
            if f > 1:
                b, h, w, c = x.shape
                x = x.to(torch.float32).reshape(b, h // f, f, w // f, f, c).mean(dim=(2, 4))
        return self._model(normalize_on_device(x, self.spec))

    # -- pipelined embedding (dispatch/complete split) ----------------------
    # Mirrors the tagger split (models/tagger.py): dispatch queues the
    # forward without syncing so the tag stage's in-flight window covers the
    # embedding too; complete fetches with one device-to-host copy.

    def dispatch_batch_prepared(self, batch_u8: np.ndarray | torch.Tensor) -> torch.Tensor:
        """Queue the embedding forward WITHOUT syncing. ``batch_u8`` may be a
        host array or a tensor already on the device (fused tag+embed
        batches share one upload), which is used as it is."""
        if isinstance(batch_u8, torch.Tensor):
            batch = batch_u8.to(self.device)
        else:
            batch = torch.from_numpy(np.ascontiguousarray(batch_u8)).to(self.device)
        with torch.inference_mode():
            return self._embed(batch)

    def complete_batch_prepared(self, pending: torch.Tensor) -> np.ndarray:
        return pending.cpu().numpy()

    def embed_batch_prepared(self, batch_u8: np.ndarray | torch.Tensor) -> np.ndarray:
        return self.complete_batch_prepared(self.dispatch_batch_prepared(batch_u8))

    def embed_batch(self, images: Sequence[np.ndarray]) -> np.ndarray:
        return self.embed_batch_prepared(self.prepare_batch_from_rgb(images))


@torch.no_grad()
def init_encoder_(model: ClipImageEncoder, generator: torch.Generator) -> ClipImageEncoder:
    """Random init in place from a seeded generator: the ViT as
    ``init_vit_`` draws it, then the projection (lecun-normal, as flax's
    Dense)."""
    init_vit_(model.vit, generator)
    weight = model.proj.weight
    values = torch.randn(weight.shape, generator=generator) / math.sqrt(weight.shape[1])
    weight.copy_(values.to(weight.dtype))
    return model


def embedder_from_catalog(
    conn,
    *,
    preset: str = "base",
    image_size: int = 224,
    patch_size: int = 32,
    embed_dim: int = 512,
    checkpoint_path: str | Path | None = None,
    model: str = "clip-vit",
    device: str | torch.device | None = None,
) -> ImageEmbedder:
    """Embedder whose prep matches the catalog's STORED vectors.

    Query-time probe images (``ket ann --query-image``) must be embedded with
    the preprocessing geometry the index run used; the catalog meta table
    records it (db.repository.ensure_embed_prep), so this factory is the way
    to build a query-side embedder."""
    from kobato_eyes_tpu_torch.db.repository import get_embed_prep

    derive = None
    prep = get_embed_prep(conn, model)
    if prep and prep.startswith("lb"):
        head, _, target = prep.partition("->mean->")
        try:
            derive = int(head[2:])
            if target and int(target) != image_size:
                logger.warning(
                    "catalog vectors were computed at %spx but index.image_size=%d; "
                    "re-index to refresh them", target, image_size,
                )
                derive = None
        except ValueError:
            logger.warning("unparseable embed prep %r in catalog meta; using plain prep", prep)
            derive = None
        if derive is not None and derive % image_size != 0:
            logger.warning(
                "recorded embed prep %r incompatible with image_size=%d; using plain prep",
                prep, image_size,
            )
            derive = None
    return ImageEmbedder(
        preset=preset, image_size=image_size, patch_size=patch_size,
        embed_dim=embed_dim, checkpoint_path=checkpoint_path, derive_from=derive,
        device=device,
    )
