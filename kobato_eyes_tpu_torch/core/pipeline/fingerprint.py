"""Tagger configuration fingerprint — the incremental-retag key.

Parity with the reference (``src/core/pipeline/signature.py:40-66``): a
stable string over tagger identity + scoring policy; any change invalidates
stored tags so the next index pass re-tags affected files.
"""

from __future__ import annotations

import hashlib


def current_tagger_sig(fields: dict[str, str]) -> str:
    """Fold a tagger's ``signature_fields()`` into a stable fingerprint."""
    ordered = ":".join(f"{k}={fields[k]}" for k in sorted(fields))
    digest = hashlib.sha256(ordered.encode()).hexdigest()[:24]
    name = fields.get("name", "unknown")
    return f"{name}:{digest}"
