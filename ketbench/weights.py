"""The tagger's label table and seeded weights, made by the harness and
handed to the port and to the plain reference alike.

Weights follow the port's own random init (lecun-normal matrices, zero
biases, unit norm scales, position embedding N(0, 0.02), SwinV2 logit scales
log 10), drawn on the card from one ``torch.Generator`` in one call. The
head's bias is set by category so that a row clears WD14's thresholds on a
few tens of labels, as a trained tagger does, and never reaches the
128-label cap.
"""

from __future__ import annotations

import math

import numpy as np
import torch

RATING_NAMES = ("general", "sensitive", "questionable", "explicit")
CATEGORY_IDS = {"general": 0, "rating": 2, "character": 4}
HEAD_STREAM = 5150  # fixed: the head's bias values do not depend on the seed


def label_table(cfg: dict) -> tuple[list[str], np.ndarray]:
    """(names, categories): WD14's order, ratings first, then general tags,
    then characters (``cfg["labels"]`` gives the counts)."""
    counts = cfg["labels"]
    names = list(RATING_NAMES[: counts["rating"]])
    names += [f"tag_{i:04d}" for i in range(counts["general"])]
    names += [f"chara_{i:04d}_(series_{i % 211:03d})" for i in range(counts["character"])]
    cats = np.concatenate([
        np.full(counts["rating"], CATEGORY_IDS["rating"]),
        np.full(counts["general"], CATEGORY_IDS["general"]),
        np.full(counts["character"], CATEGORY_IDS["character"]),
    ]).astype(np.int32)
    if len(names) != cfg["num_labels"]:
        raise ValueError(f"label counts sum to {len(names)}, not {cfg['num_labels']}")
    return names, cats


def threshold_vector(cfg: dict, cats: np.ndarray) -> np.ndarray:
    """Per-label threshold: the category's (0 where none), then the floor."""
    thr = np.zeros(len(cats), dtype=np.float64)
    for cat, value in cfg["thresholds"].items():
        thr[cats == int(cat)] = float(value)
    return np.maximum(thr, float(cfg["score_floor"]))


def head_bias(cfg: dict, cats: np.ndarray, seed: int) -> np.ndarray:
    """(num_labels,) float32 head bias (``cfg["head_bias"]``): fixed values,
    placed on labels in the seed's order."""
    spec = cfg["head_bias"]
    values = np.random.default_rng(HEAD_STREAM)
    order = np.random.default_rng(seed)
    thr = threshold_vector(cfg, cats)
    thr_logit = np.log(thr) - np.log1p(-thr)
    bias = np.full(len(cats), spec["rest"], dtype=np.float64)
    bias[cats == CATEGORY_IDS["rating"]] = spec["rating"]
    for name in ("general", "character"):
        labels = np.nonzero(cats == CATEGORY_IDS[name])[0]
        labels = labels[order.permutation(len(labels))]
        sure, border = spec["sure"][name], spec["borderline"][name]
        bias[labels[:sure]] = values.uniform(*spec["sure_bias"], sure)
        near = labels[sure : sure + border]
        bias[near] = thr_logit[near] - values.uniform(*spec["borderline_below_threshold"], border)
    return bias.astype(np.float32)


def model_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """The port's parameter names and shapes for ``cfg`` (read from the
    model built on the meta device: no memory, no init)."""
    from ketbench.model import port_model_config

    if cfg["arch"] == "vit":
        from kobato_eyes_tpu_torch.models.vit import ViT as Model
    else:
        from kobato_eyes_tpu_torch.models.swin import SwinV2 as Model
    with torch.device("meta"):
        model = Model(port_model_config(cfg))
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def make_state(cfg: dict, shapes: dict[str, tuple[int, ...]], cats: np.ndarray, seed: int, device) -> dict[str, torch.Tensor]:
    """f32 weights on ``device`` from ``seed``: every random tensor is a
    view of one ``randn`` call."""
    random_keys = [k for k, s in shapes.items() if (k.endswith("weight") and len(s) >= 2) or k == "pos_embed"]
    total = sum(math.prod(shapes[k]) for k in random_keys)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    state: dict[str, torch.Tensor] = {}
    offset = 0
    for key in random_keys:
        shape = shapes[key]
        n = math.prod(shape)
        scale = 0.02 if key == "pos_embed" else 1.0 / math.sqrt(math.prod(shape[1:]))
        state[key] = flat[offset : offset + n].view(shape).mul_(scale)
        offset += n
    head_keys = {"head.bias", "head.fc.bias"}
    for key, shape in shapes.items():
        if key in state:
            continue
        if key in head_keys:
            state[key] = torch.from_numpy(head_bias(cfg, cats, seed)).to(device)
        elif key.endswith("logit_scale"):
            state[key] = torch.full(shape, math.log(10.0), device=device)
        elif key.endswith("weight"):  # norm scales
            state[key] = torch.ones(shape, device=device)
        else:  # biases, the cls token
            state[key] = torch.zeros(shape, device=device)
    return state
