"""Tag query language and execution engines.

Grammar parity with the reference (``src/core/query.py``): AND/OR/NOT,
parentheses, implicit AND by adjacency, ``category:<name>``, ``score>=x``,
escaped parens inside tag names.  Two backends execute the same AST:

* ``kobato_eyes_tpu_torch.query.sql`` — EXISTS-subquery SQL against the host
  catalog (fallback + executable spec);
* ``kobato_eyes_tpu_torch.query.engine`` — vectorized set algebra over
  device-resident posting lists (the hot path).
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
