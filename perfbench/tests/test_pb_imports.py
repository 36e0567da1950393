"""What the benchmark may import and read: no JAX and no JAX package
(top-level module names compared whole: tpurt_torch is the program),
nothing of the program in the reference or the scene writers, and
nothing under benchmarks/."""

from __future__ import annotations

import ast
import glob
import os
import subprocess
import sys

from perfbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "tpurt"}
SOURCES = sorted(glob.glob(os.path.join(harness.HERE, "**", "*.py"), recursive=True))
SOURCES = [p for p in SOURCES if "_cache" not in p]


def imported(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    for path in SOURCES:
        assert not set(imported(path)) & FORBIDDEN, path


def test_reference_and_writers_import_nothing_of_the_program():
    for sub in ("reference", "scenes"):
        for path in glob.glob(os.path.join(harness.HERE, sub, "*.py")):
            assert "tpurt_torch" not in set(imported(path)), path
    code = ("import sys; import perfbench.check, perfbench.scenes.sponza, "
            "perfbench.scenes.helmet; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'tpurt_torch', 'tpurt', 'jax'}))")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=harness.ROOT, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def test_nothing_reads_benchmarks_dir():
    me = os.path.abspath(__file__)
    for path in SOURCES:
        if os.path.abspath(path) != me:
            assert "benchmarks" not in open(path).read(), path
