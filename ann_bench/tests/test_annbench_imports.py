"""Nothing under ann_bench/ imports JAX or the JAX package, by whole top-level
module name (`knowhere_tpu_torch` begins with `knowhere_tpu`), and the
yardstick imports nothing of the program."""

import ast
import sys
from pathlib import Path

import pytest

from ann_bench import run, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "knowhere_tpu"}
YARDSTICK = ("reference.py", "data.py", "check.py", "roofline.py", "profile.py", "spec.py")


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in spec.BENCH_DIR.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(spec.BENCH_DIR)))
def test_no_jax_by_whole_top_level_name(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("name", YARDSTICK)
def test_yardstick_imports_nothing_of_the_program(name):
    assert "knowhere_tpu_torch" not in top_level_imports(spec.BENCH_DIR / name)


def test_reference_imports_only_torch():
    assert top_level_imports(spec.BENCH_DIR / "reference.py") <= {"__future__", "typing", "torch"}


def test_the_run_checks_loaded_modules_by_whole_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "knowhere_tpu_torch_fake_for_test", sys)
    assert run.loaded_forbidden() == []  # the port's prefix is no match
    monkeypatch.setitem(sys.modules, "knowhere_tpu.models", sys)
    assert run.loaded_forbidden() == ["knowhere_tpu"]
