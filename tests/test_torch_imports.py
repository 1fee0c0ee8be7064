"""The PyTorch/CUDA port stands alone: no JAX, nothing of the JAX package.

* every port module imports in a process where ``jax`` (and the repository's
  root ``bench`` / ``tools``) cannot be imported;
* no port module (nor ``chip_smoke.py``) names ``kobato_eyes_tpu``, a JAX
  library or the repository's root ``bench`` / ``tools`` in an import;
* the port keeps the JAX package's layering;
* each host module the port copies equals its JAX counterpart (the root
  ``tools/migrate_data.py`` for the port's) after the package rename, and so does each host function a port module copies; the
  copied C++ sources equal theirs byte for byte.
"""

from __future__ import annotations

import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).parent.parent
PORT = ROOT / "kobato_eyes_tpu_torch"
JAXPKG = ROOT / "kobato_eyes_tpu"

# the repository's own measuring entry points (root ``bench.py``, ``tools/``)
# import the JAX package: the port's counterparts keep their own copies
FORBIDDEN_ROOTS = {"kobato_eyes_tpu", "jax", "jaxlib", "flax", "optax", "orbax", "bench", "tools"}

# modules the jax-blocked import must have reached, the SwinV2, dup,
# query-engine, ANN, checkpoint / upkeep, server / training / refine and
# multi-device slices' among them
REQUIRED_MODULES = [
    "kobato_eyes_tpu_torch.ops.attention",
    "kobato_eyes_tpu_torch.ops.window_attention",
    "kobato_eyes_tpu_torch.ops.layernorm_residual",
    "kobato_eyes_tpu_torch.models.swin",
    "kobato_eyes_tpu_torch.models.import_weights",
    "kobato_eyes_tpu_torch.models.validate",
    "kobato_eyes_tpu_torch.ops.phash",
    "kobato_eyes_tpu_torch.ops.hamming",
    "kobato_eyes_tpu_torch.ops.pairwise_hamming",
    "kobato_eyes_tpu_torch.ops.tile_hash",
    "kobato_eyes_tpu_torch.ops.mae",
    "kobato_eyes_tpu_torch.sig.signatures",
    "kobato_eyes_tpu_torch.native.build",
    "kobato_eyes_tpu_torch.dup.engine",
    "kobato_eyes_tpu_torch.dup.audit",
    "kobato_eyes_tpu_torch.dup.refine_clusters",
    "kobato_eyes_tpu_torch.dup.cpu_ref",
    "kobato_eyes_tpu_torch.cli",
    "kobato_eyes_tpu_torch.query.engine",
    "kobato_eyes_tpu_torch.query.snapshot",
    "kobato_eyes_tpu_torch.utils.export",
    "kobato_eyes_tpu_torch.index.embedder",
    "kobato_eyes_tpu_torch.index.flat",
    "kobato_eyes_tpu_torch.index.ivf",
    "kobato_eyes_tpu_torch.index.hnsw",
    "kobato_eyes_tpu_torch.index.auto",
    "kobato_eyes_tpu_torch.index.validate",
    "kobato_eyes_tpu_torch.core.pipeline.embed_stage",
    "kobato_eyes_tpu_torch.models.onnx_import",
    "kobato_eyes_tpu_torch.models.inspection",
    "kobato_eyes_tpu_torch.core.jobs",
    "kobato_eyes_tpu_torch.core.tag_job",
    "kobato_eyes_tpu_torch.core.watcher",
    "kobato_eyes_tpu_torch.core.pipeline.maintenance",
    "kobato_eyes_tpu_torch.db.admin",
    "kobato_eyes_tpu_torch.utils.crash",
    "kobato_eyes_tpu_torch.ops.gelu",
    "kobato_eyes_tpu_torch.ops.ssim",
    "kobato_eyes_tpu_torch.models.train",
    "kobato_eyes_tpu_torch.core.finetune",
    "kobato_eyes_tpu_torch.services.server",
    "kobato_eyes_tpu_torch.dup.refine",
    "kobato_eyes_tpu_torch.dup.cluster",
    "kobato_eyes_tpu_torch.ops.xla_math",
    "kobato_eyes_tpu_torch.parallel.mesh",
    "kobato_eyes_tpu_torch.parallel.distributed",
    "kobato_eyes_tpu_torch.parallel.sharded_scan",
    "kobato_eyes_tpu_torch.models.mesh_forward",
    "kobato_eyes_tpu_torch.query.sharded",
    "kobato_eyes_tpu_torch.utils.profiling",
    "kobato_eyes_tpu_torch.parallel.dryrun",
    "kobato_eyes_tpu_torch.bench",
    "kobato_eyes_tpu_torch.tools.trace_ops",
    "kobato_eyes_tpu_torch.tools.bench_tagger",
    "kobato_eyes_tpu_torch.tools.mfu_probe",
    "kobato_eyes_tpu_torch.tools.bench_swin",
    "kobato_eyes_tpu_torch.tools.bench_query",
    "kobato_eyes_tpu_torch.tools.bench_ann",
    "kobato_eyes_tpu_torch.tools.bench_e2e",
    "kobato_eyes_tpu_torch.tools.bench_decode",
    "kobato_eyes_tpu_torch.tools.bench_writer",
    "kobato_eyes_tpu_torch.tools.migrate_data",
    "kobato_eyes_tpu_torch.tools.coverage_gate",
    "kobato_eyes_tpu_torch.models.eva02",
    "kobato_eyes_tpu_torch.ops.rope",
    "kobato_eyes_tpu_torch.models.archs",
]

COPIED = [
    "models/base.py", "models/labels.py",
    "utils/image_io.py", "utils/hashing.py", "utils/paths.py",
    "utils/metrics.py", "utils/env.py", "utils/fs.py",
    "core/config/__init__.py", "core/config/schema.py", "core/config/service.py",
    "core/scanner.py", "core/progress.py",
    "db/connection.py", "db/schema.py", "db/repository.py",
    "core/pipeline/contracts.py", "core/pipeline/loaders.py",
    "core/pipeline/fingerprint.py", "core/pipeline/scan_stage.py",
    "services/writer.py",
    "query/ast.py", "query/sql.py",
    "utils/bits.py",
    "sig/__init__.py",
    "native/__init__.py", "native/build.py",
    "dup/__init__.py", "dup/types.py", "dup/dsu.py", "dup/cpu_ref.py",
    "utils/export.py", "query/__init__.py",
    "index/hnsw.py", "core/pipeline/embed_stage.py",
    "models/onnx_import.py", "models/inspection.py", "core/jobs.py", "db/admin.py",
    "utils/crash.py", "dup/cluster.py",
    "tools/migrate_data.py",
]
# copies whose original is not in the JAX package (the repository's root ``tools/``)
ORIGINALS = {"tools/migrate_data.py": ROOT / "tools" / "migrate_data.py"}
# host code a port module copies from its JAX counterpart: (module, top-level
# function or class), equal after the package rename
COPIED_DEFINITIONS = [
    ("core/finetune.py", "_load_training_set"),
    ("core/finetune.py", "FinetuneResult"),
]
# host C++ sources, compared byte for byte
COPIED_BYTES = ["native/hamming_scan.cpp", "native/assembly.cpp", "native/catalog_fetch.cpp",
                "native/hnsw.cpp"]

# layer rank per top-level module of the port (the JAX package's map, plus
# ``device``, which sits under everything that touches a tensor)
LAYERS: dict[str, int] = {
    "utils": 0,
    "native": 0,
    "device": 1,
    "ops": 1,
    "parallel": 1,
    "db": 2,
    "models": 2,
    "sig": 2,
    "dup": 3,
    "query": 3,
    "index": 3,
    "services": 4,
    "core": 5,
    "cli": 6,
    # the measuring entry points drive every layer, above the CLI
    "bench": 7,
    "tools": 7,
}
# a module that drives every layer, as the CLI does, ranks with the CLI
ENTRY_POINTS: dict[str, int] = {
    "parallel/dryrun.py": LAYERS["cli"],  # the multi-device dry run: each layer's sharded path
}
ALLOWED_EXCEPTIONS: set[tuple[str, str]] = {
    ("db", "models"),  # repository uses TagCategory constants only
    ("services", "core"),  # the writer consumes the pipeline's write contracts
}


def _port_sources() -> list[Path]:
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(encoding="utf-8"))
    found: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            found.add(node.module)
    return found


def test_port_imports_with_jax_blocked():
    code = (
        "import importlib, pkgutil, sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'bench', 'tools'):\n"
        "    sys.modules[name] = None\n"
        "import kobato_eyes_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        # a built native/_catalog_fetch.so, _hnsw.so or _xla_rsqrt.so is a plain C library (ctypes),
        # no Python module
        "names = [n for n in names if not n.endswith(('._catalog_fetch', '._hnsw', '._xla_rsqrt'))]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        f"missing = sorted(set({REQUIRED_MODULES!r}) - set(names))\n"
        "assert not missing, missing\n"
        "import chip_smoke\n"
        "leaked = sorted(m for m in sys.modules if m == 'kobato_eyes_tpu' or m.startswith('kobato_eyes_tpu.'))\n"
        "assert not leaked, leaked\n"
        "print(len(names))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 50


def test_ast_walk_covers_the_new_modules():
    walked = {str(p.relative_to(ROOT)) for p in _port_sources()}
    for name in REQUIRED_MODULES:
        assert name.replace(".", "/") + ".py" in walked, name


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = sorted(m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN_ROOTS)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_no_upward_imports():
    violations: list[str] = []
    for py in PORT.rglob("*.py"):
        rel = py.relative_to(PORT)
        first = rel.parts[0] if len(rel.parts) > 1 else rel.stem
        if first not in LAYERS:
            continue
        for imported in _imported_modules(py):
            parts = imported.split(".")
            if parts[0] != "kobato_eyes_tpu_torch" or len(parts) < 2:
                continue
            dst = parts[1]
            if dst not in LAYERS:
                continue
            rank = ENTRY_POINTS.get(rel.as_posix(), LAYERS[first])
            if LAYERS[dst] > rank and (first, dst) not in ALLOWED_EXCEPTIONS:
                violations.append(f"{rel}: {first} -> {imported} ({dst})")
    assert not violations, "layering violations:\n" + "\n".join(violations)


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_equals_reference(rel):
    original = ORIGINALS.get(rel, JAXPKG / rel).read_text(encoding="utf-8")
    expected = re.sub(r"\bkobato_eyes_tpu\b", "kobato_eyes_tpu_torch", original)
    assert (PORT / rel).read_text(encoding="utf-8") == expected


def _definition(path: Path, name: str) -> str:
    source = path.read_text(encoding="utf-8")
    for node in ast.parse(source).body:
        if getattr(node, "name", None) == name:
            return ast.get_source_segment(source, node)
    raise AssertionError(f"{path} has no top-level {name}")


@pytest.mark.parametrize("rel,name", COPIED_DEFINITIONS, ids=lambda v: v)
def test_copied_definition_equals_reference(rel, name):
    expected = re.sub(r"\bkobato_eyes_tpu\b", "kobato_eyes_tpu_torch", _definition(JAXPKG / rel, name))
    assert _definition(PORT / rel, name) == expected


@pytest.mark.parametrize("rel", COPIED_BYTES)
def test_copied_source_equals_reference_bytes(rel):
    assert (PORT / rel).read_bytes() == (JAXPKG / rel).read_bytes()
