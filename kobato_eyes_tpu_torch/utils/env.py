"""Environment-variable helpers.

Behavioral counterpart of the reference's ``src/utils/env.py`` (safe_int) and
its ~25 ``KE_*`` tuning flags; this build namespaces flags under ``KET_*``.
"""

from __future__ import annotations

import os


def safe_int(value: str | None, default: int | None = None) -> int | None:
    """Parse an int from an env-style string, returning *default* on failure."""
    if value is None:
        return default
    text = value.strip()
    if not text:
        return default
    try:
        return int(text)
    except ValueError:
        return default


def safe_float(value: str | None, default: float | None = None) -> float | None:
    if value is None:
        return default
    text = value.strip()
    if not text:
        return default
    try:
        return float(text)
    except ValueError:
        return default


def env_int(name: str, default: int) -> int:
    parsed = safe_int(os.environ.get(name))
    return default if parsed is None else parsed


def env_float(name: str, default: float) -> float:
    parsed = safe_float(os.environ.get(name))
    return default if parsed is None else parsed


def env_flag(name: str, default: bool = False) -> bool:
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.strip().lower() in {"1", "true", "yes", "on"}


def positive_or_none(value: str | None) -> int | None:
    """Parse a positive int, else None (semantics of KE_DUP_BUCKET_PAIR_CAP,
    reference src/dup/scanner.py:419-429)."""
    parsed = safe_int(value)
    if parsed is None or parsed <= 0:
        return None
    return parsed


def is_headless() -> bool:
    """True when running without any interactive frontend."""
    return env_flag("KET_HEADLESS", default=True)
