"""Disjoint-set union (union by rank, iterative path compression)."""

from __future__ import annotations

import numpy as np


class DisjointSet:
    """Dict-based DSU over arbitrary int ids (host clustering)."""

    def __init__(self) -> None:
        self._parent: dict[int, int] = {}
        self._rank: dict[int, int] = {}

    def find(self, item: int) -> int:
        parent = self._parent.setdefault(item, item)
        # Iterative path compression (the reference recurses; deep chains on
        # 70k-image scans would hit Python's recursion limit).
        root = item
        while self._parent[root] != root:
            root = self._parent[root]
        while parent != root:
            nxt = self._parent[item]
            self._parent[item] = root
            item = nxt
            parent = self._parent.get(item, item)
        return root

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return
        rank_a = self._rank.get(ra, 0)
        rank_b = self._rank.get(rb, 0)
        if rank_a < rank_b:
            ra, rb = rb, ra
        self._parent[rb] = ra
        if rank_a == rank_b:
            self._rank[ra] = rank_a + 1


def union_find_array(n: int, edges_i: np.ndarray, edges_j: np.ndarray) -> np.ndarray:
    """Vectorized-ish DSU over dense indices 0..n-1; returns root labels.

    Used for large edge sets where per-edge Python dict overhead matters.
    """
    parent = np.arange(n, dtype=np.int64)

    def find(x: int) -> int:
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    for a, b in zip(edges_i.tolist(), edges_j.tolist()):
        ra, rb = find(a), find(b)
        if ra != rb:
            if ra < rb:
                parent[rb] = ra
            else:
                parent[ra] = rb
    # Final flatten
    for x in range(n):
        find(x)
    return parent
