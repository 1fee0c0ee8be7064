"""Content hashing helpers (streaming sha256).

Counterpart of the reference's ``src/utils/hash.py:10`` (1 MiB chunked sha256
used for scan change detection).
"""

from __future__ import annotations

import hashlib
from pathlib import Path

_CHUNK = 1 << 20


def compute_sha256(path: str | Path) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as fh:
        while True:
            block = fh.read(_CHUNK)
            if not block:
                break
            digest.update(block)
    return digest.hexdigest()


def sha256_of_bytes(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()
