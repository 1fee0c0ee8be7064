"""Tag query semantics in NumPy, over the postings the harness generated.

A query is a tree: ``("tag", name)``, ``("cat", category)``,
``("score", op, value)``, ``("not", x)``, ``("and", x, y)``, ``("or", x, y)``.
A tag term holds for a file with a posting of that tag whose score clears
the gate of the tag's category (general, character and copyright have their
own thresholds; any other category the default); a category term for a file
with a posting of that category at or above the category's threshold; a
score term for a file with any posting that satisfies it. The catalog holds
scores as float32 values and the tag-query epoch compares them in float32,
so the gates here are compared in float32 too.

A page orders the matching files by relevance (the float64 sum, in the
order the positive terms first appear, of the scores of the query's
positive tags that clear their gates), then by mtime, newest first, then by
file id, and keeps the first ``limit`` (the ordering of the catalog's SQL
search).

``precision="bfloat16"`` rounds every score to bfloat16 first (the control).
"""

from __future__ import annotations

import numpy as np

THRESHOLDS = {0: 0.35, 4: 0.25, 3: 0.25, -1: 0.0}  # general, character, copyright, default
CASED = (0, 4, 3)
NUM_CATEGORIES = 6


def to_bfloat16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even), as float32."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


class Catalog:
    def __init__(
        self, *, file_ids: np.ndarray, mtimes: np.ndarray, rows: np.ndarray, labels: np.ndarray,
        scores: np.ndarray, names: list[str], cats: np.ndarray, precision: str = "float32",
    ) -> None:
        n = len(file_ids)
        scores32 = np.asarray(scores, dtype=np.float32)
        if precision == "bfloat16":
            scores32 = to_bfloat16(scores32)
        elif precision != "float32":
            raise ValueError(f"unknown precision {precision!r}")
        order = np.argsort(labels, kind="stable")
        self.rows = rows[order]
        self.scores32 = scores32[order]
        self.scores64 = self.scores32.astype(np.float64)
        self.offsets = np.searchsorted(labels[order], np.arange(len(names) + 1))
        self.file_ids, self.mtimes = file_ids, mtimes
        self.cats = cats
        self.index = {name: i for i, name in enumerate(names)}
        self.smax = np.full(n, -np.inf, dtype=np.float32)
        self.smin = np.full(n, np.inf, dtype=np.float32)
        np.maximum.at(self.smax, rows, scores32)
        np.minimum.at(self.smin, rows, scores32)
        self.cat_max = np.full((n, NUM_CATEGORIES), -np.inf, dtype=np.float32)
        np.maximum.at(self.cat_max, (rows, cats[labels]), scores32)

    def _gate(self, label: int) -> float:
        cat = int(self.cats[label])
        return THRESHOLDS[cat] if cat in CASED else THRESHOLDS[-1]

    def _postings(self, label: int) -> slice:
        return slice(int(self.offsets[label]), int(self.offsets[label + 1]))

    def evaluate(self, node: tuple) -> np.ndarray:
        kind = node[0]
        n = len(self.file_ids)
        if kind == "tag":
            mask = np.zeros(n, dtype=bool)
            label = self.index.get(node[1])
            if label is not None:
                sl = self._postings(label)
                hit = self.scores32[sl] >= np.float32(self._gate(label))
                mask[self.rows[sl][hit]] = True
            return mask
        if kind == "cat":
            return self.cat_max[:, node[1]] >= np.float32(THRESHOLDS.get(node[1], 0.0))
        if kind == "score":
            op, t = node[1], np.float32(node[2])
            if op == ">=":
                return self.smax >= t
            if op == ">":
                return self.smax > t
            if op == "<=":
                return self.smin <= t
            if op == "<":
                return self.smin < t
            mask = np.zeros(n, dtype=bool)
            mask[self.rows[self.scores32 == t]] = True
            return mask
        if kind == "not":
            return ~self.evaluate(node[1])
        if kind == "and":
            return self.evaluate(node[1]) & self.evaluate(node[2])
        if kind == "or":
            return self.evaluate(node[1]) | self.evaluate(node[2])
        raise ValueError(f"unknown node {node!r}")

    def search(self, tree: tuple, *, limit: int) -> list[int]:
        """The file ids of the page, in order."""
        rel = np.zeros(len(self.file_ids), dtype=np.float64)
        for name in positive_tags(tree):
            label = self.index.get(name)
            if label is None:
                continue
            sl = self._postings(label)
            sc = self.scores64[sl]
            hit = sc >= self._gate(label)
            rel[self.rows[sl][hit]] += sc[hit]
        idx = np.nonzero(self.evaluate(tree))[0]
        order = np.lexsort((self.file_ids[idx], -self.mtimes[idx], -rel[idx]))
        return [int(i) for i in self.file_ids[idx[order[:limit]]]]


def positive_tags(tree: tuple) -> list[str]:
    """Tags under an even number of negations, first appearance first."""
    out: list[str] = []

    def walk(node: tuple, negated: bool) -> None:
        kind = node[0]
        if kind == "tag":
            if not negated and node[1] not in out:
                out.append(node[1])
        elif kind == "not":
            walk(node[1], not negated)
        elif kind in ("and", "or"):
            walk(node[1], negated)
            walk(node[2], negated)

    walk(tree, False)
    return out
