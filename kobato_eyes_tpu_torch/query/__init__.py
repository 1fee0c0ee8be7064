"""Tag query language: the AST and its SQL backend.

The device query engine (``query/engine.py`` in the JAX package) comes with
a later slice of the port.
"""

from kobato_eyes_tpu_torch.query.ast import (
    AndExpr,
    CategoryExpr,
    Expr,
    NotExpr,
    OrExpr,
    ScoreExpr,
    TagExpr,
    extract_positive_tag_terms,
    parse_query,
)
from kobato_eyes_tpu_torch.query.sql import QueryFragment, translate_query

__all__ = [
    "AndExpr", "CategoryExpr", "Expr", "NotExpr", "OrExpr", "ScoreExpr",
    "TagExpr", "QueryFragment", "extract_positive_tag_terms", "parse_query",
    "translate_query",
]
