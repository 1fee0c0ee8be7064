"""Model/checkpoint inspection: detect the tagger family, summarize config.

Counterpart of the reference's ``src/tagger/model_inspection.py``
(auto-detect wd14-vs-pixai from output head size — PixAI expects 13461
labels, model_inspection.py:13-15 — plus a user-facing summary).  Here the
inspected artifacts are label CSVs and orbax checkpoints instead of ONNX
graphs; detection keys on label count and label-table shape.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

from kobato_eyes_tpu_torch.models.base import TagCategory
from kobato_eyes_tpu_torch.models.labels import TagMeta, discover_labels_csv, load_labels

PIXAI_LABEL_COUNT = 13461  # reference model_inspection.py:15
_DETECTION_TOLERANCE = 200


@dataclass(frozen=True)
class ModelInspection:
    family: str  # "wd14" | "pixai" | "unknown"
    label_count: int
    labels_path: Path | None
    checkpoint_path: Path | None
    category_counts: dict[int, int]
    has_ips_links: bool
    notes: list[str]

    def summary(self) -> str:
        cats = ", ".join(
            f"{TagCategory(c).name.lower()}={n}" for c, n in sorted(self.category_counts.items())
        )
        lines = [
            f"family: {self.family}",
            f"labels: {self.label_count} ({cats})",
            f"labels file: {self.labels_path or 'n/a'}",
            f"checkpoint: {self.checkpoint_path or 'random-init'}",
            f"character->copyright links: {'yes' if self.has_ips_links else 'no'}",
        ]
        lines.extend(f"note: {n}" for n in self.notes)
        return "\n".join(lines)


def detect_family(labels: list[TagMeta]) -> str:
    """Label-table shape -> tagger family (reference _looks_like_pixai_output)."""
    n = len(labels)
    if abs(n - PIXAI_LABEL_COUNT) <= _DETECTION_TOLERANCE or any(m.ips for m in labels):
        return "pixai"
    if 6000 <= n <= 12000:
        return "wd14"
    return "unknown"


def inspect_model(
    *,
    checkpoint_path: str | Path | None = None,
    labels_path: str | Path | None = None,
) -> ModelInspection:
    """Inspect a (checkpoint, labels) pair; tolerant of missing pieces."""
    notes: list[str] = []
    ckpt = Path(checkpoint_path) if checkpoint_path else None
    labels_file = Path(labels_path) if labels_path else None
    if labels_file is None and ckpt is not None:
        labels_file = discover_labels_csv(ckpt)
        if labels_file is not None:
            notes.append(f"labels discovered next to checkpoint: {labels_file.name}")

    labels: list[TagMeta] = []
    if labels_file is not None and labels_file.exists():
        try:
            labels = load_labels(labels_file)
        except (OSError, ValueError) as exc:
            notes.append(f"label CSV unreadable: {exc}")
    elif labels_file is not None:
        notes.append("labels file does not exist")

    if ckpt is not None and not ckpt.exists():
        notes.append("checkpoint path does not exist")
    elif ckpt is not None and ckpt.suffix == ".onnx":
        # the reference's release format: summarize the embedded weights
        # (initializer inventory) like model_inspection.py's ONNX metadata
        try:
            from kobato_eyes_tpu_torch.models.onnx_import import read_onnx_initializers

            inits = read_onnx_initializers(ckpt)
            n_params = sum(a.size for a in inits.values())
            notes.append(
                f"onnx weights: {len(inits)} initializers, {n_params / 1e6:.1f}M params "
                f"(convert with `ket import-weights`)"
            )
        except Exception as exc:  # inspection is tolerant, never fatal
            notes.append(f"onnx file unreadable: {exc}")

    counts: dict[int, int] = {}
    for m in labels:
        counts[int(m.category)] = counts.get(int(m.category), 0) + 1

    return ModelInspection(
        family=detect_family(labels) if labels else "unknown",
        label_count=len(labels),
        labels_path=labels_file,
        checkpoint_path=ckpt,
        category_counts=counts,
        has_ips_links=any(m.ips for m in labels),
        notes=notes,
    )
