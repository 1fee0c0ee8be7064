"""AST -> SQL WHERE fragment (host catalog backend).

Same compilation scheme as the reference (``src/core/query.py:330-429``):
each term becomes an EXISTS subquery against file_tags⋈tags; tag terms gate
on a per-category threshold CASE.  This backend is the fallback path and the
executable spec the device engine is verified against.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

from kobato_eyes_tpu_torch.models.base import TagCategory
from kobato_eyes_tpu_torch.query.ast import (
    AndExpr,
    CategoryExpr,
    Expr,
    NotExpr,
    OrExpr,
    ScoreExpr,
    TagExpr,
    parse_query,
)

# Canonical thresholds contract lives with the catalog spec (db/repository);
# re-exported here because the query layer is the usual consumer.
from kobato_eyes_tpu_torch.db.repository import (  # noqa: E402
    FALLBACK_THRESHOLDS,
    normalize_thresholds,
)


@dataclass(frozen=True)
class QueryFragment:
    where: str
    params: list[object]


def _case_params(thr: dict[int, float]) -> list[float]:
    return [
        thr.get(int(TagCategory.GENERAL), 0.0),
        thr.get(int(TagCategory.CHARACTER), 0.0),
        thr.get(int(TagCategory.COPYRIGHT), 0.0),
        thr.get(-1, 0.0),
    ]


_THRESHOLD_CASE = (
    "ft.score >= CASE t.category "
    f"WHEN {int(TagCategory.GENERAL)} THEN ? "
    f"WHEN {int(TagCategory.CHARACTER)} THEN ? "
    f"WHEN {int(TagCategory.COPYRIGHT)} THEN ? "
    "ELSE ? END"
)


def _compile(expr: Expr, alias: str, thr: dict[int, float] | None) -> tuple[str, list[object]]:
    if isinstance(expr, TagExpr):
        if thr is None:
            return (
                "EXISTS (SELECT 1 FROM file_tags ft JOIN tags t ON t.id = ft.tag_id "
                f"WHERE ft.file_id = {alias}.id AND t.name = ?)",
                [expr.name],
            )
        return (
            "EXISTS (SELECT 1 FROM file_tags ft JOIN tags t ON t.id = ft.tag_id "
            f"WHERE ft.file_id = {alias}.id AND t.name = ? AND {_THRESHOLD_CASE})",
            [expr.name, *_case_params(thr)],
        )
    if isinstance(expr, CategoryExpr):
        cat = int(expr.category)
        if thr is None:
            return (
                "EXISTS (SELECT 1 FROM file_tags ft JOIN tags t ON t.id = ft.tag_id "
                f"WHERE ft.file_id = {alias}.id AND t.category = ?)",
                [cat],
            )
        return (
            "EXISTS (SELECT 1 FROM file_tags ft JOIN tags t ON t.id = ft.tag_id "
            f"WHERE ft.file_id = {alias}.id AND t.category = ? AND ft.score >= ?)",
            [cat, float(thr.get(cat, 0.0))],
        )
    if isinstance(expr, ScoreExpr):
        if expr.op not in (">=", "<=", "=", ">", "<"):
            raise ValueError(f"bad score operator {expr.op!r}")
        return (
            f"EXISTS (SELECT 1 FROM file_tags ft WHERE ft.file_id = {alias}.id "
            f"AND ft.score {expr.op} ?)",
            [expr.threshold],
        )
    if isinstance(expr, NotExpr):
        inner, params = _compile(expr.operand, alias, thr)
        return f"NOT ({inner})", params
    if isinstance(expr, (AndExpr, OrExpr)):
        op = "AND" if isinstance(expr, AndExpr) else "OR"
        ls, lp = _compile(expr.left, alias, thr)
        rs, rp = _compile(expr.right, alias, thr)
        return f"({ls}) {op} ({rs})", lp + rp
    raise TypeError(f"unhandled expression {expr!r}")


def translate_query(
    query: str,
    *,
    file_alias: str = "f",
    thresholds: Mapping[int, float] | None = None,
) -> QueryFragment:
    """Query string -> WHERE fragment. Empty query matches everything.

    Pass ``thresholds`` (possibly ``{}``) to apply per-category score gates
    merged over the fallbacks; pass ``None`` to match on mere tag presence.
    """
    expr = parse_query(query)
    if expr is None:
        return QueryFragment(where="1=1", params=[])
    thr = None if thresholds is None else normalize_thresholds(thresholds)
    where, params = _compile(expr, file_alias, thr)
    return QueryFragment(where=where, params=params)
