"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level names; the reference imports nothing of the port."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest
from conftest import ROOT

from benchmark.lib.device import FORBIDDEN, forbidden_modules

FILES = sorted((ROOT / "benchmark").rglob("*.py"))
REFERENCE_MAY_IMPORT = {"__future__", "contextlib", "math", "numpy", "torch",
                        "benchmark"}


def top_level_imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_anywhere(path):
    tops = {n.split(".", 1)[0] for n in top_level_imports(path)}
    assert not tops & set(FORBIDDEN)


@pytest.mark.parametrize(
    "path", [p for p in FILES if p.parent.name == "reference"],
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names = top_level_imports(path)
    assert {n.split(".", 1)[0] for n in names} <= REFERENCE_MAY_IMPORT
    assert all(n.startswith("benchmark.reference") for n in names
               if n.split(".", 1)[0] == "benchmark")


def test_forbidden_modules_compares_whole_top_level_names():
    mods = {"transformerupscaler_torch": 1, "transformerupscaler_torch.x": 1,
            "jaxtyping": 1, "flaxen.y": 1, "jax": 1, "jax.numpy": 1,
            "transformerupscaler_tpu.ops": 1, "orbax.checkpoint": 1}
    assert forbidden_modules(mods) == ["jax", "jax.numpy",
                                       "orbax.checkpoint",
                                       "transformerupscaler_tpu.ops"]


def test_a_run_without_the_program_fails(bench_copy):
    """In a directory with only ``BENCHMARK.json`` and the benchmark's
    files, a run exits with an error and prints no result."""
    root, _ = bench_copy
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "fast_live_1080p_4k", "--seed", "1", "--seconds", "1"],
                       cwd=root, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
