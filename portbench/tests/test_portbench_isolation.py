"""Nothing under portbench/ imports JAX or the JAX package (top-level
module names compared whole); the reference imports nothing of the
port; nothing reads the JAX package's benchmark folder."""
from __future__ import annotations

import ast
import sys

from portbench_tiny import ROOT
from portbench import run as R

FORBIDDEN = {"jax", "jaxlib", "flax", "aline_tpu"}
SOURCES = sorted((ROOT / "portbench").rglob("*.py"))


def imported(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_jax_anywhere():
    assert SOURCES
    for p in SOURCES:
        assert not imported(p) & FORBIDDEN, p


def test_reference_imports_nothing_of_the_port():
    for p in (ROOT / "portbench" / "reference").rglob("*.py"):
        assert "aline_tpu_torch" not in imported(p), p
        assert "aline_tpu_torch" not in p.read_text(), p


def test_nothing_reads_the_jax_benchmarks():
    for p in SOURCES:
        if p.parent.name != "tests":
            assert "benchmarks/" not in p.read_text(), p


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "aline_tpu_torch_like", sys)
    assert "aline_tpu" not in R.forbidden_modules()
    monkeypatch.setitem(sys.modules, "aline_tpu.eval", sys)
    assert R.forbidden_modules() == ["aline_tpu"]
