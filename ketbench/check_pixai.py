"""The comparison that decides ``correct`` in a PixAI tagging cell.

A row the tagger returned is held to the plain reference's logits for the
same picture under PixAI's semantics: per category (general, character) the
labels at or over ``max(threshold, floor)``, highest first, at most the
category's cap; each character linked by ``ips`` to copyright names, which
are not labels, gives each of them its score (a copyright's score is the
highest of its returned characters'); copyrights under their threshold are
dropped and capped like the rest; the whole row at most ``cap``.

- For each label returned, the gap between the logit of its score and the
  reference's logit for that label.
- For each copyright returned, the gap between the logit of its score and
  the highest reference logit of its returned characters.
- For each label the reference puts over its category's threshold that the
  row lacks, how far over; where the category is full, the cut is the
  category's own lowest returned score. The same for a copyright missing
  beside a character the reference selects or the row returned.

``logit_gap`` is the widest of these. A row that names an unknown label or
copyright, gives one another category, repeats one, is out of score order,
has a score outside (0, 1), passes a category's cap or the row's, or returns
a copyright with none of its characters counts in ``bad_rows``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ketbench.check import logit

COPYRIGHT, CHARACTER = 3, 4


@dataclass
class PixaiTable:
    """The label table and the selection's knobs."""

    names: list[str]
    cats: np.ndarray
    ips: dict[int, tuple[str, ...]]  # character label -> its copyright names
    thresholds: dict[int, float]
    floor: float
    limits: dict[int, int]
    cap: int
    index: dict[str, int] = field(init=False)
    links: dict[str, list[int]] = field(init=False)  # copyright name -> its characters

    def __post_init__(self) -> None:
        self.index = {name: i for i, name in enumerate(self.names)}
        self.links = {}
        for char, names in sorted(self.ips.items()):
            for name in names:
                self.links.setdefault(name, []).append(char)

    def gate(self, cat: int) -> float:
        return max(self.thresholds.get(cat, 0.0), self.floor)

    def limit(self, cat: int) -> int:
        return min(self.limits.get(cat, self.cap), self.cap)

    def threshold_vector(self) -> np.ndarray:
        return np.array([self.gate(int(c)) for c in self.cats], dtype=np.float64)


def compare_pixai_rows(rows: list[list[tuple[str, float, int]]], ref_logits: np.ndarray,
                       table: PixaiTable) -> dict[str, float]:
    cats = table.cats
    thr_logit = logit(table.threshold_vector())
    cased = [int(c) for c in np.unique(cats)]
    gap = 0.0
    bad = 0
    hits = copyrights = 0
    for row, ref in zip(rows, np.asarray(ref_logits, dtype=np.float64)):
        ok = len(row) <= table.cap
        seen = np.zeros(len(cats), dtype=bool)
        got_copyright: dict[str, float] = {}
        counts: dict[int, int] = {}
        low: dict[int, float] = {}
        prev = np.inf
        for name, score, cat in row:
            j = table.index.get(name)
            if j is not None:
                valid = int(cat) == int(cats[j]) and not seen[j]
            else:
                valid = name in table.links and int(cat) == COPYRIGHT and name not in got_copyright
            if not valid or not 0.0 < score < 1.0 or score > prev:
                ok = False
                continue
            prev = score
            counts[int(cat)] = counts.get(int(cat), 0) + 1
            low[int(cat)] = score
            if j is not None:
                seen[j] = True
                gap = max(gap, abs(float(logit(score)) - ref[j]))
            else:
                got_copyright[name] = score
        ok &= all(n <= table.limit(c) for c, n in counts.items())

        def raised(cat: int) -> float:
            """The logit a category's missing labels must pass beyond its
            threshold: its lowest score where it is full, the row's where
            the row is."""
            out = -np.inf
            if counts.get(cat, 0) >= table.limit(cat):
                out = float(logit(low[cat])) if cat in low else np.inf
            if len(row) >= table.cap:
                out = max(out, float(logit(row[-1][1])))
            return out

        cut = thr_logit.copy()
        for cat in cased:
            np.maximum(cut, raised(cat), out=cut, where=cats == cat)
        missing = (ref >= cut) & ~seen
        if missing.any():
            gap = max(gap, float((ref[missing] - cut[missing]).max()))

        for name, score in got_copyright.items():
            linked = [c for c in table.links[name] if seen[c]]
            if not linked:
                ok = False
                continue
            gap = max(gap, abs(float(logit(score)) - float(ref[linked].max())))
        # a copyright the row lacks beside a character it returned or the reference selects
        chars = set(np.nonzero((cats == CHARACTER) & (seen | (ref >= cut)))[0].tolist())
        c_cut = max(float(logit(table.gate(COPYRIGHT))), raised(COPYRIGHT))
        for name in {n for c in chars for n in table.ips.get(c, ())} - set(got_copyright):
            best = max(float(ref[c]) for c in table.links[name] if c in chars)
            if best >= c_cut:
                gap = max(gap, best - c_cut)
        hits += len(row)
        copyrights += len(got_copyright)
        bad += not ok
    n = max(len(rows), 1)
    return {"logit_gap": gap, "bad_rows": float(bad), "tags_per_row": hits / n, "copyright_rows_per_row": copyrights / n}


def select_rows(logits: np.ndarray, table: PixaiTable) -> list[list[tuple[str, float, int]]]:
    """Rows as PixAI's selection makes them from ``logits``, plainly: each
    category's labels at or over the gate, highest first (lower label first
    on ties), at most its cap; each character's copyrights at the highest of
    their characters' scores; the gate again, then every entry by score
    (name on ties) under the category caps and the row's. The control's
    answers are made this way from the lower-precision reference."""
    probs = 1.0 / (1.0 + np.exp(-np.asarray(logits, dtype=np.float64)))
    cats = table.cats
    rows = []
    for p in probs:
        merged: dict[str, tuple[float, int]] = {}
        for cat in np.unique(cats):
            cat = int(cat)
            hit = np.nonzero((cats == cat) & (p >= table.gate(cat)))[0]
            for j in hit[np.argsort(-p[hit], kind="stable")][: table.limit(cat)]:
                merged[table.names[j]] = (float(np.float32(p[j])), cat)
        for name, (score, cat) in list(merged.items()):
            if cat != CHARACTER:
                continue
            for ip in table.ips.get(table.index[name], ()):
                merged[ip] = (max(score, merged.get(ip, (score, COPYRIGHT))[0]), COPYRIGHT)
        ordered = sorted(((n, s, c) for n, (s, c) in merged.items() if s >= table.gate(c)),
                         key=lambda e: (-e[1], e[0]))
        row: list[tuple[str, float, int]] = []
        used: dict[int, int] = {}
        for name, score, cat in ordered:
            if len(row) >= table.cap:
                break
            if used.get(cat, 0) >= table.limit(cat):
                continue
            used[cat] = used.get(cat, 0) + 1
            row.append((name, score, cat))
        rows.append(row)
    return rows


def drop_one_copyright(rows: list[list[tuple[str, float, int]]]) -> list:
    """A fault: the first copyright of the first row that has one is left out."""
    out = [list(r) for r in rows]
    for r in out:
        for k, (_, _, cat) in enumerate(r):
            if int(cat) == COPYRIGHT:
                del r[k]
                return out
    return out
