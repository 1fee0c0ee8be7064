"""Label-table loading (selected_tags.csv-style).

Behavioral parity with the reference loader (``src/tagger/labels_util.py``):
header aliasing, category by name or number, optional ``ips`` JSON column
linking characters to copyrights, broken-row placeholders that preserve row
order, CSV discovery next to the model file, and popularity ordering.
"""

from __future__ import annotations

import csv
import json
import logging
from dataclasses import dataclass, field
from pathlib import Path

from kobato_eyes_tpu_torch.models.base import TagCategory

logger = logging.getLogger(__name__)

# Accepted header spellings (reference labels_util.py:82-106 aliasing).
_NAME_KEYS = ("name", "tag", "tag_name")
_CATEGORY_KEYS = ("category", "category_id", "type")
_COUNT_KEYS = ("count", "post_count", "popularity")
_IPS_KEYS = ("ips", "copyrights")

_CATEGORY_BY_NAME = {
    "general": TagCategory.GENERAL,
    "artist": TagCategory.ARTIST,
    "rating": TagCategory.RATING,
    "copyright": TagCategory.COPYRIGHT,
    "character": TagCategory.CHARACTER,
    "meta": TagCategory.META,
}

BROKEN_PLACEHOLDER_PREFIX = "__broken_"


@dataclass(frozen=True)
class TagMeta:
    """One label row: model output index == row order."""

    name: str
    category: TagCategory
    count: int = 0
    ips: tuple[str, ...] = field(default_factory=tuple)


def parse_category(raw: str | int | None) -> TagCategory:
    if raw is None or raw == "":
        return TagCategory.GENERAL
    if isinstance(raw, int):
        return TagCategory(raw)
    text = str(raw).strip().lower()
    if text in _CATEGORY_BY_NAME:
        return _CATEGORY_BY_NAME[text]
    try:
        return TagCategory(int(text))
    except (ValueError, KeyError):
        return TagCategory.GENERAL


def _pick(row: dict[str, str], keys: tuple[str, ...]) -> str | None:
    for key in keys:
        if key in row and row[key] not in (None, ""):
            return row[key]
    return None


def load_labels(csv_path: str | Path) -> list[TagMeta]:
    """Parse a label CSV; row order defines the model output index.

    Malformed rows become ``__broken_<row>`` placeholders so indices stay
    aligned with the model output (reference labels_util.py:133,186).
    """
    path = Path(csv_path)
    labels: list[TagMeta] = []
    with path.open("r", encoding="utf-8", newline="") as fh:
        reader = csv.DictReader(fh)
        if reader.fieldnames is None:
            raise ValueError(f"label CSV has no header: {path}")
        normalized_fields = {f.strip().lower(): f for f in reader.fieldnames}
        for i, raw_row in enumerate(reader):
            row = {k.strip().lower(): (v or "").strip() for k, v in raw_row.items() if k}
            name = _pick(row, _NAME_KEYS)
            if not name:
                labels.append(TagMeta(name=f"{BROKEN_PLACEHOLDER_PREFIX}{i}", category=TagCategory.GENERAL))
                continue
            category = parse_category(_pick(row, _CATEGORY_KEYS))
            count_raw = _pick(row, _COUNT_KEYS)
            try:
                count = int(float(count_raw)) if count_raw else 0
            except ValueError:
                count = 0
            ips: tuple[str, ...] = ()
            ips_raw = _pick(row, _IPS_KEYS)
            if ips_raw:
                try:
                    parsed = json.loads(ips_raw)
                    if isinstance(parsed, list):
                        ips = tuple(str(x) for x in parsed if x)
                except json.JSONDecodeError:
                    logger.debug("bad ips JSON at row %d of %s", i, path)
            labels.append(TagMeta(name=name, category=category, count=count, ips=ips))
    del normalized_fields
    return labels


def verify_label_order(
    labels: list[TagMeta], tag_map_path: str | Path
) -> tuple[list[TagMeta], int]:
    """Verify (and repair) the label table against a PixAI tag_map JSON.

    Reference ``src/tagger/pixai_onnx.py:109-167``: the JSON's ``tag_map``
    (name -> model output index) is the authority on label ORDER — a shuffled
    or stale CSV silently mislabels every prediction, which is exactly the
    failure this check exists for.  Returns ``(labels, mismatches)``:

    * the expected name for index i comes from tag_map; empty names and
      missing indices become ``__broken_<i>`` placeholders;
    * zero mismatches -> the input list is returned unchanged;
    * otherwise names are replaced by the JSON's order and categories/ips are
      rebuilt by looking the new name up in the CSV-derived metadata
      (unknown names fall back to GENERAL, like the reference repair).
    """
    path = Path(tag_map_path)
    data = json.loads(path.read_text(encoding="utf-8"))
    tag_map = data.get("tag_map") or {}
    if not tag_map:
        logger.warning("tag_map missing in %s; skipping label-order check", path)
        return labels, 0

    n = len(labels)
    expected: list[str | None] = [None] * n
    for name, idx in tag_map.items():
        i = int(idx)
        if 0 <= i < n:
            expected[i] = str(name) if name else f"{BROKEN_PLACEHOLDER_PREFIX}{i}"
    for i in range(n):
        if expected[i] is None:
            expected[i] = f"{BROKEN_PLACEHOLDER_PREFIX}{i}"

    mismatches = sum(1 for i in range(n) if expected[i] != labels[i].name)
    if mismatches == 0:
        logger.info("label order matches %s", path)
        return labels, 0

    logger.warning(
        "label order mismatch vs %s: %d / %d rows differ; repairing from tag_map",
        path, mismatches, n,
    )
    by_name = {m.name: m for m in labels}
    repaired: list[TagMeta] = []
    for i, name in enumerate(expected):
        meta = by_name.get(name)
        if meta is not None:
            repaired.append(TagMeta(name=name, category=meta.category,
                                    count=meta.count, ips=meta.ips))
        else:
            repaired.append(TagMeta(name=name, category=TagCategory.GENERAL))
    return repaired, mismatches


def discover_tag_map_json(model_path: str | Path) -> Path | None:
    """Find the PixAI tag_map JSON next to the model (reference candidates)."""
    import os

    model = Path(model_path)
    candidates = [
        model.parent / "tags_v0.9_13k.json",
        model.parent / "pixai_tags.json",
    ]
    env = os.environ.get("KET_PIXAI_TAGS_JSON", "")
    if env:
        candidates.append(Path(env))
    for cand in candidates:
        if cand.is_file():
            return cand
    return None


def discover_labels_csv(model_path: str | Path) -> Path | None:
    """Find a label CSV next to the model file (reference labels_util.py:269)."""
    model = Path(model_path)
    candidates = [
        model.with_suffix(".csv"),
        model.parent / "selected_tags.csv",
        model.parent / "tags.csv",
    ]
    for cand in candidates:
        if cand.is_file():
            return cand
    hits = sorted(model.parent.glob("*.csv"))
    return hits[0] if hits else None


def labels_by_popularity(labels: list[TagMeta]) -> list[TagMeta]:
    return sorted(labels, key=lambda m: (-m.count, m.name))


def synthetic_labels(n: int, *, seed: int = 0) -> list[TagMeta]:
    """Deterministic label table for tests / random-weight models.

    Category mix loosely follows real Danbooru label tables: mostly GENERAL,
    a minority of CHARACTER/COPYRIGHT, 4 RATING rows up front.
    """
    labels: list[TagMeta] = []
    for i in range(n):
        if i < 4:
            cat = TagCategory.RATING
        elif i % 17 == 0:
            cat = TagCategory.CHARACTER
        elif i % 23 == 0:
            cat = TagCategory.COPYRIGHT
        elif i % 31 == 0:
            cat = TagCategory.META
        else:
            cat = TagCategory.GENERAL
        labels.append(TagMeta(name=f"tag_{i}", category=cat, count=n - i))
    return labels
