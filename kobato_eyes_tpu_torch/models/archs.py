"""The tagger's archs: the one place that names them.

``ARCHS`` maps the name that ``TorchTagger(arch=...)``, a checkpoint's
manifest and ``ket import-weights --arch`` use to an :class:`Arch`: how to
build the arch's config and module, initialise it, hold its state to a
key/shape manifest, convert a timm state into it, sign it and speed it up.
Adding an arch is one entry here beside its model file, manifest and
converter (``models/import_weights.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import torch

from kobato_eyes_tpu_torch.models import import_weights as iw
from kobato_eyes_tpu_torch.models.eva02 import EVA02, EVA02Config, eva02_config, init_eva02_
from kobato_eyes_tpu_torch.models.swin import SwinConfig, SwinV2, init_swin_, swin_config
from kobato_eyes_tpu_torch.models.vit import ViT, ViTConfig, init_vit_, vit_config


def _has(state: Mapping[str, Any], prefix: str) -> bool:
    """``prefix.weight`` or ``prefix.bias`` is in ``state`` (a folded .onnx
    export renames the weight, but its bias keeps its name)."""
    return f"{prefix}.weight" in state or f"{prefix}.bias" in state


@dataclasses.dataclass(frozen=True)
class Arch:
    """One tagger arch. ``clip``: a CLIP visual tower, or a ``clip``
    checkpoint directory, also imports through this arch's config."""

    name: str
    config: type
    preset_config: Callable[..., Any]  # (preset, **overrides) -> config
    default_preset: str
    module: type[torch.nn.Module]
    init: Callable[[Any, torch.Generator], Any]  # random init in place
    state_manifest: Callable[[Any], dict[str, tuple[int, ...]]]  # the port state's keys and shapes
    timm_manifest: Callable[[Any, Mapping[str, Any]], dict[str, tuple[int, ...]]]  # (cfg, a timm state's head)
    from_timm: Callable[[Mapping[str, Any], Any], dict[str, torch.Tensor]]  # (timm state, cfg) -> port state
    signature: Callable[[Any], str]  # ``signature_fields()["arch"]``
    gelu: bool  # its MLP's GELU may become tanh-gelu (SwiGLU has none)
    on_mesh: bool  # the mesh forward takes it
    clip: bool = False

    def fast(self, cfg: Any) -> Any:
        """The ``fast_math`` rewrite of an einsum config: the attention
        kernel, plus tanh-gelu where an erf GELU can be swapped."""
        if cfg.attn_impl != "einsum" or (self.gelu and cfg.act != "gelu"):
            return cfg
        return dataclasses.replace(cfg, attn_impl="pallas", **({"act": "gelu_tanh"} if self.gelu else {}))


ARCHS: dict[str, Arch] = {
    "vit": Arch(
        "vit", ViTConfig, vit_config, "base", ViT, init_vit_, iw.vit_state_manifest,
        lambda cfg, state: iw.vit_state_manifest(cfg, head=_has(state, "head")),
        iw.vit_params_from_torch_state,
        lambda c: f"vit-d{c.depth}-h{c.hidden_dim}-p{c.patch_size}-{c.image_size}",
        gelu=True, on_mesh=True, clip=True,
    ),
    "swinv2": Arch(
        "swinv2", SwinConfig, swin_config, "base", SwinV2, init_swin_, iw.swin_state_manifest,
        lambda cfg, state: iw.swin_state_manifest(cfg, head_style="fc" if _has(state, "head.fc") else "flat"),
        iw.swin_params_from_torch_state,
        lambda c: f"swinv2-e{c.embed_dim}-d{'.'.join(map(str, c.depths))}-w{c.window_size}-{c.image_size}",
        gelu=True, on_mesh=True,
    ),
    "eva02": Arch(
        "eva02", EVA02Config, eva02_config, "large", EVA02, init_eva02_, iw.eva02_state_manifest,
        lambda cfg, state: iw.eva02_state_manifest(cfg, head=_has(state, "head")),
        iw.eva02_params_from_torch_state,
        lambda c: f"eva02-d{c.depth}-h{c.hidden_dim}-p{c.patch_size}-m{c.mlp_hidden}-{c.image_size}",
        gelu=False, on_mesh=False,
    ),
}


def arch_of(cfg: Any) -> Arch:
    """The entry whose config ``cfg`` is."""
    arch = next((a for a in ARCHS.values() if isinstance(cfg, a.config)), None)
    if arch is None:
        raise TypeError(f"{type(cfg).__name__} is no tagger arch's config ({' | '.join(ARCHS)})")
    return arch
