"""Tagger postprocessing: device top-K, host category budgets.

Counterpart of ``kobato_eyes_tpu/models/postprocess.py``. The O(B*C) part —
probability conversion, threshold masking, top-K — runs in torch on the
tagger's device; the budget walk over <=topk_cap candidates runs on the host
and is the same code as the JAX package's.

Semantics preserved:
* sigmoid applied only when outputs look like logits (any value outside [0,1],
  tested over the whole batch), rounded as XLA rounds ``jax.nn.sigmoid``
  (``ops/xla_math.py``: a CUDA pass on the card);
* per-category threshold vector, unspecified categories -> 0.0, then a global
  score floor applied as max(threshold, floor);
* top-K keeps the lower label index first among equal scores, as
  ``jax.lax.top_k`` does: a stable descending sort, then the first K. (With
  bf16 logits many probabilities tie exactly, and the 128-tag cap falls on
  ties; ``torch.topk`` promises no order among them.)
"""

from __future__ import annotations

import numpy as np
import torch

from kobato_eyes_tpu_torch.models.base import (
    MaxTagsMap,
    TagCategory,
    TagPrediction,
    TagResult,
    ThresholdMap,
)
from kobato_eyes_tpu_torch.models.labels import TagMeta
from kobato_eyes_tpu_torch.ops.xla_math import xla_sigmoid_f32

NEG_INF = float("-inf")


# ---------------------------------------------------------------------------
# Device side
# ---------------------------------------------------------------------------


def probs_from_logits(logits: torch.Tensor) -> torch.Tensor:
    """Sigmoid-if-logits (reference wd14_onnx.py:546-548), batch-global test."""
    logits = logits.to(torch.float32)
    already_probs = (logits.min() >= 0.0) & (logits.max() <= 1.0)
    return torch.where(already_probs, logits, xla_sigmoid_f32(logits))


def _stable_topk(masked: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along dim 1 with ties broken toward the lower index."""
    scores, idx = torch.sort(masked, dim=1, descending=True, stable=True)
    return scores[:, :k], idx[:, :k]


def topk_hits(probs: torch.Tensor, thr_vec: torch.Tensor, *, k: int):
    """(B, C) probs -> (scores, indices, hit_counts) of top-k threshold hits.

    Non-hits score -inf so the host can trim; k is the hard cap.
    """
    hit = probs >= thr_vec[None, :]
    masked = torch.where(hit, probs, NEG_INF)
    scores, idx = _stable_topk(masked, k)
    return scores, idx, hit.sum(dim=1, dtype=torch.int32)


def topk_hits_by_category(
    probs: torch.Tensor,
    thr_vec: torch.Tensor,
    cat_vec: torch.Tensor,
    *,
    caps: tuple[tuple[int, int], ...],
):
    """Per-category top-cap hits (PixAI candidate extraction).

    ``caps`` is a tuple of (category, cap). Returns concatenated
    (scores, indices) with -inf padding.
    """
    hit = probs >= thr_vec[None, :]
    n_labels = probs.shape[1]
    parts_s = []
    parts_i = []
    for cat, cap in caps:
        mask = hit & (cat_vec[None, :] == cat)
        masked = torch.where(mask, probs, NEG_INF)
        s, i = _stable_topk(masked, min(cap, n_labels))
        parts_s.append(s)
        parts_i.append(i)
    return torch.cat(parts_s, dim=1), torch.cat(parts_i, dim=1)


# ---------------------------------------------------------------------------
# Host side (vectors prepared once per tagger)
# ---------------------------------------------------------------------------


def build_threshold_vector(
    cats: np.ndarray,
    thresholds: ThresholdMap,
    *,
    score_floor: float = 0.0,
) -> np.ndarray:
    """Per-label threshold vector (reference _build_threshold_vector +
    _with_score_floor): unspecified categories get 0.0, then the global floor."""
    vec = np.zeros(cats.shape[0], dtype=np.float32)
    for cat, thr in thresholds.items():
        vec[cats == int(cat)] = float(thr)
    if score_floor > 0.0:
        np.maximum(vec, score_floor, out=vec)
    return vec


def resolve_limits(
    defaults: MaxTagsMap | None, overrides: MaxTagsMap | None
) -> dict[int, int | None]:
    limits: dict[int, int | None] = {int(k): v for k, v in (defaults or {}).items()}
    for k, v in (overrides or {}).items():
        limits[int(k)] = v
    return limits


def _budget_walk(
    ordered: list[tuple[int, float]],
    cats: np.ndarray,
    names: list[str],
    limits: dict[int, int | None],
    hard_cap: int,
) -> TagResult:
    """Greedy score-order selection under per-category budgets."""
    taken: list[TagPrediction] = []
    per_cat: dict[int, int] = {}
    for idx, score in ordered:
        if len(taken) >= hard_cap:
            break
        cat = int(cats[idx])
        limit = limits.get(cat)
        used = per_cat.get(cat, 0)
        if limit is not None and used >= limit:
            continue
        per_cat[cat] = used + 1
        taken.append(TagPrediction(name=names[idx], score=float(score), category=TagCategory(cat)))
    return TagResult(tags=taken)


def select_wd14(
    scores: np.ndarray,  # (B, K) device top-k scores (-inf padded)
    indices: np.ndarray,  # (B, K)
    hit_counts: np.ndarray,  # (B,)
    *,
    cats: np.ndarray,
    names: list[str],
    limits: dict[int, int | None],
    hard_cap: int,
) -> list[TagResult]:
    """WD14 candidate truncation + budget walk (wd14_onnx.py:556-625)."""
    has_unbounded = any(v is None for v in limits.values())
    base_cap = (
        None
        if has_unbounded or not limits
        else max(sum(int(v) for v in limits.values() if v is not None), 64)
    )
    results: list[TagResult] = []
    for b in range(scores.shape[0]):
        hits = int(hit_counts[b])
        if hits == 0:
            results.append(TagResult(tags=[]))
            continue
        k = min(hits, hard_cap) if base_cap is None else min(hits, base_cap, hard_cap)
        row_s = scores[b]
        row_i = indices[b]
        ordered = [
            (int(row_i[j]), float(row_s[j])) for j in range(min(k, row_s.shape[0])) if np.isfinite(row_s[j])
        ]
        results.append(_budget_walk(ordered, cats, names, limits, hard_cap))
    return results


def select_pixai(
    scores: np.ndarray,  # (B, sumcaps) per-category top-cap scores (-inf padded)
    indices: np.ndarray,
    probs_rows: np.ndarray | None,  # (B, C) full prob rows for ips lookup (or None)
    *,
    cats: np.ndarray,
    names: list[str],
    limits: dict[int, int | None],
    hard_cap: int,
    cat_thresholds: ThresholdMap | None = None,
    score_floor: float = 0.0,
    tag_meta: dict[str, TagMeta] | None = None,
    name_to_idx: dict[str, int] | None = None,
) -> list[TagResult]:
    """PixAI selection: ips copyright merge, threshold re-check, budget walk
    (pixai_onnx.py:340-395)."""
    from kobato_eyes_tpu_torch.models.labels import BROKEN_PLACEHOLDER_PREFIX

    thr_by_cat = {int(k): float(v) for k, v in (cat_thresholds or {}).items()}
    results: list[TagResult] = []
    for b in range(scores.shape[0]):
        merged: dict[str, tuple[float, int]] = {}
        for j in range(scores.shape[1]):
            s = float(scores[b, j])
            if not np.isfinite(s):
                continue
            idx = int(indices[b, j])
            name = names[idx]
            prev = merged.get(name)
            if prev is None or s > prev[0]:
                merged[name] = (s, int(cats[idx]))
        # character -> copyright propagation
        if tag_meta and name_to_idx is not None:
            for name, (score, cat) in list(merged.items()):
                if cat != int(TagCategory.CHARACTER):
                    continue
                meta = tag_meta.get(name)
                if not meta or not meta.ips:
                    continue
                for ip_name in meta.ips:
                    ip_score = score
                    ip_idx = name_to_idx.get(ip_name)
                    if probs_rows is not None and ip_idx is not None:
                        ip_score = max(ip_score, float(probs_rows[b, ip_idx]))
                    existing = merged.get(ip_name)
                    if existing is not None:
                        ip_score = max(ip_score, existing[0])
                    merged[ip_name] = (ip_score, int(TagCategory.COPYRIGHT))
        # Post-merge filtering (pixai_onnx.py:366-378): drop placeholder rows
        # and re-apply max(category threshold, floor) — ips-merged copyrights
        # may land below the copyright threshold.
        filtered: dict[str, tuple[float, int]] = {}
        for name, (score, cat) in merged.items():
            if name.startswith(BROKEN_PLACEHOLDER_PREFIX):
                continue
            if score < max(thr_by_cat.get(cat, 0.0), score_floor):
                continue
            filtered[name] = (score, cat)
        ordered_names = sorted(filtered.items(), key=lambda kv: (-kv[1][0], kv[0]))
        taken: list[TagPrediction] = []
        per_cat: dict[int, int] = {}
        for name, (score, cat) in ordered_names:
            if len(taken) >= hard_cap:
                break
            limit = limits.get(cat)
            used = per_cat.get(cat, 0)
            if limit is not None and used >= limit:
                continue
            per_cat[cat] = used + 1
            taken.append(TagPrediction(name=name, score=score, category=TagCategory(cat)))
        results.append(TagResult(tags=taken))
    return results
