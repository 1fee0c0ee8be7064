"""Query tokenizer and recursive-descent parser.

Reimplements the reference grammar exactly (``src/core/query.py:92-296``):

* whitespace-separated words; ``|``/``OR`` (any case) is OR, ``AND`` is AND,
  ``NOT`` / leading ``-`` is negation;
* adjacency is implicit AND (``a b`` == ``a AND b``);
* parentheses group, but a word containing both ``(`` and ``)`` (and not
  starting with ``-(``) is a *tag name with parens* and is kept whole;
  ``\\(``/``\\)`` escape parens inside tag names;
* an unmatched ``(`` only opens a group when a closing paren exists later;
* ``category:<name>`` (general/artist/rating/copyright/character/meta);
* ``score<op><number>`` with op in ``>= <= = > <``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

from kobato_eyes_tpu_torch.models.base import TagCategory

CATEGORY_ALIASES: dict[str, TagCategory] = {
    "general": TagCategory.GENERAL,
    "artist": TagCategory.ARTIST,
    "rating": TagCategory.RATING,
    "copyright": TagCategory.COPYRIGHT,
    "character": TagCategory.CHARACTER,
    "meta": TagCategory.META,
}

SCORE_RE = re.compile(r"score\s*(>=|<=|=|>|<)\s*([0-9]*\.?[0-9]+)", re.IGNORECASE)


# -- AST --------------------------------------------------------------------


class Expr:
    pass


@dataclass(frozen=True)
class TagExpr(Expr):
    name: str


@dataclass(frozen=True)
class CategoryExpr(Expr):
    category: TagCategory


@dataclass(frozen=True)
class ScoreExpr(Expr):
    op: str
    threshold: float


@dataclass(frozen=True)
class NotExpr(Expr):
    operand: Expr


@dataclass(frozen=True)
class AndExpr(Expr):
    left: Expr
    right: Expr


@dataclass(frozen=True)
class OrExpr(Expr):
    left: Expr
    right: Expr


# -- lexer ------------------------------------------------------------------

_LPAREN = "("
_RPAREN = ")"


def _contains_unescaped_rparen(text: str, start: int = 0) -> bool:
    i = start
    while i < len(text):
        ch = text[i]
        if ch == "\\" and i + 1 < len(text) and text[i + 1] in "()":
            i += 2
            continue
        if ch == _RPAREN:
            return True
        i += 1
    return False


def _chunk_word(word: str, depth: int, future_rparen: bool) -> tuple[list[str], int]:
    """Split one whitespace word into paren/operand chunks, tracking depth."""
    # A word carrying both parens (and not a negated group) is a tag name
    # like ``character_(series)`` — keep it whole.
    if _LPAREN in word and _RPAREN in word and not word.startswith("-("):
        return [word], depth
    chunks: list[str] = []
    buf: list[str] = []
    i = 0
    while i < len(word):
        ch = word[i]
        if ch == "\\" and i + 1 < len(word) and word[i + 1] in "()":
            buf.append(word[i : i + 2])
            i += 2
            continue
        if ch == _LPAREN and (
            word == _LPAREN or _contains_unescaped_rparen(word, i + 1) or future_rparen
        ):
            if buf:
                chunks.append("".join(buf))
                buf.clear()
            chunks.append(_LPAREN)
            depth += 1
        elif ch == _RPAREN and depth > 0:
            if buf:
                chunks.append("".join(buf))
                buf.clear()
            chunks.append(_RPAREN)
            depth -= 1
        else:
            buf.append(ch)
        i += 1
    if buf:
        chunks.append("".join(buf))
    return [c for c in chunks if c], depth


@dataclass(frozen=True)
class Token:
    kind: str  # LPAREN RPAREN AND OR NOT TAG CATEGORY SCORE
    value: str


def tokenize(query: str) -> list[Token]:
    words = query.split()
    tokens: list[Token] = []
    depth = 0
    for wi, word in enumerate(words):
        future = any(_contains_unescaped_rparen(w) for w in words[wi + 1 :])
        chunks, depth = _chunk_word(word, depth, future)
        for chunk in chunks:
            if chunk.startswith("-") and len(chunk) > 1:
                tokens.append(Token("NOT", "-"))
                chunk = chunk[1:]
            upper = chunk.upper()
            if chunk == _LPAREN:
                tokens.append(Token("LPAREN", chunk))
            elif chunk == _RPAREN:
                tokens.append(Token("RPAREN", chunk))
            elif chunk == "-":
                tokens.append(Token("NOT", chunk))
            elif upper == "AND":
                tokens.append(Token("AND", chunk))
            elif chunk == "|" or upper == "OR":
                tokens.append(Token("OR", chunk))
            elif upper == "NOT":
                tokens.append(Token("NOT", chunk))
            elif chunk.lower().startswith("category:"):
                name = chunk.split(":", 1)[1].lower()
                if name not in CATEGORY_ALIASES:
                    raise ValueError(f"Unknown category '{name}'")
                tokens.append(Token("CATEGORY", name))
            elif SCORE_RE.fullmatch(chunk):
                tokens.append(Token("SCORE", chunk))
            else:
                tokens.append(Token("TAG", chunk.replace(r"\(", "(").replace(r"\)", ")")))
    return tokens


# -- parser -----------------------------------------------------------------

_OPERAND_KINDS = frozenset({"TAG", "CATEGORY", "SCORE", "LPAREN", "NOT"})


class _Cursor:
    def __init__(self, tokens: list[Token]) -> None:
        self.tokens = tokens
        self.pos = 0

    def peek(self) -> Token | None:
        return self.tokens[self.pos] if self.pos < len(self.tokens) else None

    def take(self, kind: str) -> bool:
        tok = self.peek()
        if tok is not None and tok.kind == kind:
            self.pos += 1
            return True
        return False

    def next(self) -> Token | None:
        tok = self.peek()
        if tok is not None:
            self.pos += 1
        return tok


def parse_query(query: str) -> Expr | None:
    """Parse to AST; empty query -> None; bad syntax -> ValueError."""
    tokens = tokenize(query)
    if not tokens:
        return None
    cur = _Cursor(tokens)
    expr = _parse_or(cur)
    leftover = cur.peek()
    if leftover is not None:
        raise ValueError(f"Unexpected token '{leftover.value}'")
    return expr


def _parse_or(cur: _Cursor) -> Expr:
    left = _parse_and(cur)
    while cur.take("OR"):
        left = OrExpr(left, _parse_and(cur))
    return left


def _parse_and(cur: _Cursor) -> Expr:
    left = _parse_not(cur)
    while True:
        if cur.take("AND"):
            left = AndExpr(left, _parse_not(cur))
            continue
        tok = cur.peek()
        if tok is not None and tok.kind in _OPERAND_KINDS:
            left = AndExpr(left, _parse_not(cur))  # implicit AND by adjacency
            continue
        return left


def _parse_not(cur: _Cursor) -> Expr:
    if cur.take("NOT"):
        return NotExpr(_parse_not(cur))
    return _parse_primary(cur)


def _parse_primary(cur: _Cursor) -> Expr:
    if cur.take("LPAREN"):
        inner = _parse_or(cur)
        if not cur.take("RPAREN"):
            raise ValueError("Missing closing parenthesis")
        return inner
    tok = cur.next()
    if tok is None:
        raise ValueError("Unexpected end of query")
    if tok.kind == "TAG":
        return TagExpr(tok.value)
    if tok.kind == "CATEGORY":
        return CategoryExpr(CATEGORY_ALIASES[tok.value])
    if tok.kind == "SCORE":
        m = SCORE_RE.fullmatch(tok.value)
        assert m is not None
        return ScoreExpr(m.group(1), float(m.group(2)))
    raise ValueError(f"Unsupported token '{tok.value}'")


def extract_positive_tag_terms(query: str) -> list[str]:
    """Non-negated tag names in first-appearance order, lowercased
    (reference core/query.py:432-466) — drives relevance + highlighting."""
    expr = parse_query(query)
    if expr is None:
        return []
    seen: set[str] = set()
    out: list[str] = []

    def walk(node: Expr, negated: bool) -> None:
        if isinstance(node, TagExpr):
            name = node.name.strip()
            if negated or not name or name.endswith(":"):
                return
            lowered = name.lower()
            if lowered not in seen:
                seen.add(lowered)
                out.append(lowered)
        elif isinstance(node, NotExpr):
            walk(node.operand, not negated)
        elif isinstance(node, (AndExpr, OrExpr)):
            walk(node.left, negated)
            walk(node.right, negated)

    walk(expr, False)
    return out
