"""Shared fixture of the port's tests: the host C++ modules, built once.

Import ``native_built`` into a test module to build and load the port's
``_hamming_scan`` and ``_assembly`` extensions before its tests run.
"""

from __future__ import annotations

import fcntl
from pathlib import Path

import pytest

ROOT = Path(__file__).parent.parent


@pytest.fixture(scope="module", autouse=True)
def native_built():
    """Build the port's host C++ modules once, under a lock: test files in
    other worker processes build the same ``_*.so`` files. Returns the
    loaded modules by name."""
    from kobato_eyes_tpu_torch.native.build import load_extension_module

    lock = ROOT / "build" / "native_build.lock"
    lock.parent.mkdir(exist_ok=True)
    with lock.open("w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            return {name: load_extension_module(name) for name in ("hamming_scan", "assembly")}
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)
