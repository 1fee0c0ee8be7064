"""Compile-on-first-use loader for the C++ runtime pieces.

Builds ``<name>.cpp`` next to this file into ``_<name>.so`` with g++ -O3 when
the shared object is missing or older than its source, then loads it with
ctypes.  Keeps the repo toolchain-light (no pybind11 dependency) while the
hot host paths stay native.
"""

from __future__ import annotations

import ctypes
import logging
import subprocess
import threading
from pathlib import Path

logger = logging.getLogger(__name__)

_NATIVE_DIR = Path(__file__).parent
_LOCK = threading.Lock()
_CACHE: dict[str, ctypes.CDLL] = {}


class NativeBuildError(RuntimeError):
    """g++ compilation of a native component failed."""


def load_extension_module(name: str):
    """Load (building if needed) a CPython extension module ``<name>.cpp``.

    Unlike :func:`load_native_library` (plain C ABI via ctypes), this builds
    against the CPython API — used where the hot path must construct Python
    objects (e.g. the dup-cluster assembly burst).  The module must define
    ``PyInit__<name>``.
    """
    import importlib.machinery
    import importlib.util
    import sysconfig

    with _LOCK:
        key = f"module:{name}"
        if key in _CACHE:
            return _CACHE[key]
        src = _NATIVE_DIR / f"{name}.cpp"
        so = _NATIVE_DIR / f"_{name}.so"
        if not src.exists():
            raise FileNotFoundError(src)
        if not so.exists() or so.stat().st_mtime < src.stat().st_mtime:
            tmp = so.with_suffix(".tmp.so")
            include = sysconfig.get_paths()["include"]
            cmd = [
                "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
                f"-I{include}", str(src), "-o", str(tmp),
            ]
            logger.info("building native extension: %s", " ".join(cmd))
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise NativeBuildError(f"g++ failed for {name}:\n{proc.stderr}")
            tmp.replace(so)
        loader = importlib.machinery.ExtensionFileLoader(f"_{name}", str(so))
        spec = importlib.util.spec_from_loader(f"_{name}", loader)
        mod = importlib.util.module_from_spec(spec)
        loader.exec_module(mod)
        _CACHE[key] = mod
        return mod


def object_ids_np(seq):
    """uint64 ``id()`` column for a list — one native pass, numpy fallback.

    The identity-delta caches (dup engine prep, NodeColumnCache) validate
    cache rows by object identity; at 70k items the np.fromiter(map(id, ...))
    pass is ~10x slower than the C loop in assembly.cpp:object_ids.
    """
    import numpy as np

    if isinstance(seq, list):
        try:
            mod = load_extension_module("assembly")
            return np.frombuffer(mod.object_ids(seq), dtype=np.uint64)
        except Exception:
            logger.debug("native object_ids unavailable", exc_info=True)
    return np.fromiter(map(id, seq), dtype=np.uint64, count=len(seq))


def load_native_library(name: str, *, extra_link_args: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Load (building if needed) the shared object for ``name``."""
    with _LOCK:
        if name in _CACHE:
            return _CACHE[name]
        src = _NATIVE_DIR / f"{name}.cpp"
        so = _NATIVE_DIR / f"_{name}.so"
        if not src.exists():
            raise FileNotFoundError(src)
        if not so.exists() or so.stat().st_mtime < src.stat().st_mtime:
            # build to a temp path and rename: processes holding the old .so
            # mapped keep the old inode (in-place overwrite would corrupt them)
            tmp = so.with_suffix(".tmp.so")
            # NOTE: no -ffast-math — loading a shared object built with it
            # flips FTZ/DAZ in the whole process's FP state (crtfastmath),
            # silently breaking subnormal arithmetic for every other library.
            cmd = [
                "g++", "-O3", "-march=native", "-funroll-loops",
                "-fno-math-errno", "-std=c++17", "-shared", "-fPIC",
                str(src), "-o", str(tmp), *extra_link_args,
            ]
            logger.info("building native component: %s", " ".join(cmd))
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise NativeBuildError(f"g++ failed for {name}:\n{proc.stderr}")
            tmp.replace(so)
        lib = ctypes.CDLL(str(so))
        _CACHE[name] = lib
        return lib
