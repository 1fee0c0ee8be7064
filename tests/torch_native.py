"""Shared fixture of the port's tests: the host C++ modules, built once.

Import ``native_built`` into a test module to build and load the
``_hamming_scan`` and ``_assembly`` extensions of the port and of the JAX
package before its tests run; import ``catalog_fetch_built`` for the
``_catalog_fetch`` library (plain C, loaded with ctypes) that both packages'
epoch builds read a catalog file through, and ``hnsw_built`` for both
packages' ``_hnsw`` graph library (plain C). (The port's ``_xla_rsqrt``
library, which reads the host's rsqrt estimate table, takes the same lock
itself: ``ops/xla_math.rsqrt_estimate_table``.)
"""

from __future__ import annotations

import fcntl
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).parent.parent
MODULES = ("hamming_scan", "assembly")
JAX_LOAD_TIMEOUT_S = 120.0


CATALOG_FETCH_LINK = ("-l:libsqlite3.so.0",)


def _load_jax_module(name: str, library: bool = False, link: tuple[str, ...] = ()):
    """The JAX package's extension (or, with ``library``, its plain-C
    library linked with ``link``), through its own loader. That loader builds
    to one fixed temporary name with no lock between processes, and its own
    tests in other workers build without this fixture's lock: a load that
    meets a half-written or just-renamed file is tried again until the other
    build has finished. A compiler's own error is raised at once: only a
    failed g++ whose message names the shared temporary file (another build
    renamed it away first) belongs to the race."""
    from kobato_eyes_tpu.native.build import NativeBuildError, load_extension_module, load_native_library

    deadline = time.monotonic() + JAX_LOAD_TIMEOUT_S
    while True:
        try:
            if library:
                return load_native_library(name, extra_link_args=link)
            return load_extension_module(name)
        except (ImportError, OSError, NativeBuildError) as exc:
            raced = not isinstance(exc, NativeBuildError) or f"_{name}.tmp.so" in str(exc)
            if not raced or time.monotonic() >= deadline:
                raise
            time.sleep(0.5)


def _under_build_lock(build):
    lock = ROOT / "build" / "native_build.lock"
    lock.parent.mkdir(exist_ok=True)
    with lock.open("w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            return build()
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


@pytest.fixture(scope="module", autouse=True)
def native_built():
    """Build both packages' host C++ modules once, under a lock: test files
    in other worker processes build the same ``_*.so`` files. Returns the
    port's loaded modules by name, and the JAX package's under ``"jax"``."""
    from kobato_eyes_tpu_torch.native.build import load_extension_module

    def build():
        built = {name: load_extension_module(name) for name in MODULES}
        built["jax"] = {name: _load_jax_module(name) for name in MODULES}
        return built

    return _under_build_lock(build)


@pytest.fixture(scope="module", autouse=True)
def catalog_fetch_built():
    """Build and load both packages' ``_catalog_fetch.so`` under the same
    lock, so an epoch build in a test finds the library loaded and its native
    fetch route runs. Returns (the port's library, the JAX package's)."""
    from kobato_eyes_tpu_torch.native.build import load_native_library

    def build():
        return (load_native_library("catalog_fetch", extra_link_args=CATALOG_FETCH_LINK),
                _load_jax_module("catalog_fetch", library=True, link=CATALOG_FETCH_LINK))

    return _under_build_lock(build)


@pytest.fixture(scope="module", autouse=True)
def hnsw_built():
    """Build and load both packages' ``_hnsw.so`` under the same lock, so
    test files in other workers never meet a half-written graph library.
    Returns (the port's library, the JAX package's)."""
    from kobato_eyes_tpu_torch.native.build import load_native_library

    def build():
        return load_native_library("hnsw"), _load_jax_module("hnsw", library=True)

    return _under_build_lock(build)
