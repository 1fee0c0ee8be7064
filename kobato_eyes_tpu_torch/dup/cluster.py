"""Cluster builder over refined pair matches.

Counterpart of the reference's ``src/dup/cluster.py:19-70``: DSU over
``RefinedMatch.is_duplicate`` edges; each cluster keeps its smallest file_id
as representative and carries the contributing matches.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from kobato_eyes_tpu_torch.dup.dsu import DisjointSet
from kobato_eyes_tpu_torch.dup.refine import RefinedMatch


@dataclass(frozen=True)
class Cluster:
    representative: int
    members: list[int]
    matches: list[RefinedMatch] = field(default_factory=list)


class ClusterBuilder:
    """Accumulate refined matches and emit clusters of confirmed duplicates."""

    def __init__(self) -> None:
        self._dsu = DisjointSet()
        self._matches: list[RefinedMatch] = []
        self._ids: set[int] = set()

    def add_match(self, match: RefinedMatch | None) -> None:
        if match is None or not match.is_duplicate:
            return
        self._matches.append(match)
        self._dsu.union(match.file_id_a, match.file_id_b)
        self._ids.add(match.file_id_a)
        self._ids.add(match.file_id_b)

    def build(self) -> list[Cluster]:
        groups: dict[int, list[int]] = {}
        for fid in self._ids:
            groups.setdefault(self._dsu.find(fid), []).append(fid)
        clusters: list[Cluster] = []
        for members in groups.values():
            if len(members) < 2:
                continue
            members.sort()
            rep = members[0]
            member_set = set(members)
            matches = [
                m for m in self._matches
                if m.file_id_a in member_set and m.file_id_b in member_set
            ]
            clusters.append(Cluster(representative=rep, members=members, matches=matches))
        clusters.sort(key=lambda c: c.representative)
        return clusters
