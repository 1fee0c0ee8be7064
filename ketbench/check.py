"""The comparisons that decide ``correct``.

Tags: a row the tagger returned is held to the plain reference's logits for
the same picture. For each tag returned, the gap between the logit of its
score and the reference's logit; for each label the reference puts over its
threshold (and, in a full row, over the row's lowest returned score) that the
row lacks, how far the reference puts it over. ``logit_gap`` is the widest
of these over the rows compared; a row that names an unknown label, gives a
label another category, repeats one, holds more than the cap, is out of
score order or has a score outside (0, 1) counts in ``bad_rows``.
"""

from __future__ import annotations

import numpy as np

_P_EDGE = 2.0**-24


def logit(p) -> np.ndarray:
    p = np.clip(np.asarray(p, dtype=np.float64), _P_EDGE, 1.0 - _P_EDGE)
    return np.log(p) - np.log1p(-p)


def compare_tag_rows(
    rows: list[list[tuple[str, float, int]]], ref_logits: np.ndarray,
    names: list[str], cats: np.ndarray, thr: np.ndarray, cap: int,
) -> dict[str, float]:
    index = {name: i for i, name in enumerate(names)}
    thr_logit = logit(thr)
    gap = 0.0
    bad = 0
    hits = 0
    for row, ref in zip(rows, np.asarray(ref_logits, dtype=np.float64)):
        ok = len(row) <= cap
        seen = np.zeros(len(names), dtype=bool)
        prev = np.inf
        low = np.inf
        for name, score, cat in row:
            j = index.get(name)
            if j is None or seen[j] or int(cat) != int(cats[j]) or not 0.0 < score < 1.0 or score > prev:
                ok = False
                continue
            seen[j] = True
            prev = low = score
            gap = max(gap, abs(float(logit(score)) - ref[j]))
        cut = thr_logit if len(row) < cap else np.maximum(thr_logit, logit(low))
        missing = (ref >= cut) & ~seen
        if missing.any():
            gap = max(gap, float((ref[missing] - cut[missing]).max()))
        hits += len(row)
        bad += not ok
    return {"logit_gap": gap, "bad_rows": float(bad), "tags_per_row": hits / max(len(rows), 1)}


def select_rows(logits: np.ndarray, names: list[str], cats: np.ndarray, thr: np.ndarray, cap: int):
    """Rows as the WD14 selection makes them from ``logits``: every label at
    or over its threshold, highest score first (lower label first on ties),
    at most ``cap``. The control's answers are made this way from the
    lower-precision reference."""
    probs = 1.0 / (1.0 + np.exp(-np.asarray(logits, dtype=np.float64)))
    rows = []
    for p in probs:
        hit = np.nonzero(p >= thr)[0]
        order = hit[np.argsort(-p[hit], kind="stable")][:cap]
        rows.append([(names[j], float(np.float32(p[j])), int(cats[j])) for j in order])
    return rows


def alter_one_answer(rows: list[list[tuple[str, float, int]]]) -> list:
    """A fault: the first tag of the first non-empty row gets another score."""
    out = [list(r) for r in rows]
    for r in out:
        if r:
            name, score, cat = r[0]
            r[0] = (name, float(np.float32(score * 0.75)), cat)
            break
    return out


def half_batch_left_out(rows: list[list[tuple[str, float, int]]]) -> list:
    """A fault: the batch's second half gets no rows."""
    return [list(r) for r in rows[: len(rows) // 2]]
