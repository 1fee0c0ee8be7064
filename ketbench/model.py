"""The system under test: the port's WD14 tagger built from a
configuration file, with the harness's weights and labels."""

from __future__ import annotations

import numpy as np
import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def port_model_config(cfg: dict):
    """The port's ``ViTConfig`` / ``SwinConfig`` for a configuration file."""
    common = dict(
        image_size=cfg["image_size"], patch_size=cfg["patch_size"], num_classes=cfg["num_labels"],
        dtype=_DTYPES[cfg["dtype"]], param_dtype=_DTYPES[cfg["param_dtype"]],
        attn_impl=cfg["attn_impl"], act=cfg["hidden_act"],
    )
    if cfg["arch"] == "vit":
        from kobato_eyes_tpu_torch.models.vit import ViTConfig

        return ViTConfig(
            hidden_dim=cfg["hidden_size"], depth=cfg["num_hidden_layers"],
            num_heads=cfg["num_attention_heads"], mlp_dim=cfg["intermediate_size"],
            pool=cfg["pool"], **common,
        )
    from kobato_eyes_tpu_torch.models.swin import SwinConfig

    return SwinConfig(
        embed_dim=cfg["embed_dim"], depths=tuple(cfg["depths"]), num_heads=tuple(cfg["num_heads"]),
        window_size=cfg["window_size"], mlp_ratio=cfg["mlp_ratio"], ln_impl=cfg["ln_impl"], **common,
    )


def build_tagger(cfg: dict, state: dict, names: list[str], cats: np.ndarray, device: str):
    """A ``WD14Tagger`` on ``device`` holding a copy of ``state``; its
    modules are built on the device, so the weights never cross to the host."""
    from kobato_eyes_tpu_torch.models.base import TagCategory
    from kobato_eyes_tpu_torch.models.labels import TagMeta
    from kobato_eyes_tpu_torch.models.tagger import WD14Tagger

    labels = [TagMeta(name=n, category=TagCategory(int(c))) for n, c in zip(names, cats)]
    model_cfg = port_model_config(cfg)
    kind = "vit" if cfg["arch"] == "vit" else "swin"
    with torch.device(device):
        return WD14Tagger(
            **{kind: model_cfg}, labels=labels, params=state,
            thresholds={int(k): float(v) for k, v in cfg["thresholds"].items()},
            score_floor=cfg["score_floor"], topk_cap=cfg["topk_cap"],
            fast_math=False, device=device,
        )


def result_rows(results) -> list[list[tuple[str, float, int]]]:
    """``TagResult``s as plain (name, score, category) rows."""
    return [[(t.name, float(t.score), int(t.category)) for t in r.tags] for r in results]
