"""No module of the benchmark imports JAX or the JAX package (whole
top-level names: the port's name begins with the JAX package's), and no
plain reference imports the port."""

import ast

import pytest

from ketbench.core import BENCH_DIR, FORBIDDEN_MODULES


def imported_top_levels(path):
    tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


SOURCES = sorted(BENCH_DIR.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_jax(path):
    assert not set(imported_top_levels(path)) & set(FORBIDDEN_MODULES)


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "kobato_eyes_tpu_torch" not in set(imported_top_levels(path))


def test_guard_compares_whole_names():
    from ketbench.core import loaded_forbidden_modules

    assert "kobato_eyes_tpu_torch" not in FORBIDDEN_MODULES
    assert all(m.split(".")[0] != "kobato_eyes_tpu" for m in loaded_forbidden_modules() if m.startswith("kobato_eyes_tpu_torch"))
