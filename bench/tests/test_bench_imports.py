"""Nothing under bench/ loads JAX or the JAX package, and the reference
imports nothing of the port."""
from __future__ import annotations

import ast
import subprocess
import sys

from bench.harness.runner import FORBIDDEN, forbidden_modules
from bench_fixtures import ROOT

BENCH = ROOT / "bench"


def _imports(path) -> set[str]:
    """Top-level names of every module ``path`` imports (absolute)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_under_bench_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        bad = _imports(f) & set(FORBIDDEN)
        assert not bad, f"{f.relative_to(ROOT)} imports {bad}"
        if f.name != "test_bench_imports.py":
            assert "benchmarks/" not in f.read_text(), f


def test_the_reference_imports_nothing_of_the_port():
    files = sorted((BENCH / "reference").rglob("*.py"))
    assert files
    for f in files:
        names = _imports(f)
        assert "repro_torch" not in names, f
        assert names <= {"__future__", "bench", "contextlib", "math",
                         "statistics", "typing", "torch", "numpy"}, (f, names)


def test_names_are_compared_whole(monkeypatch):
    """``repro_torch`` begins with ``repro`` and is allowed; ``repro``
    itself, or a module under it, is not.  (The forbidden modules that
    other tests of this process loaded are set aside first.)"""
    for name in [m for m in sys.modules if m.split(".")[0] in FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro_torch_like.x", sys)
    assert "repro" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro" in forbidden_modules()


def test_a_run_loads_no_forbidden_module():
    """A fresh process that imports the harness, every driver and reader
    and the port's modules a run uses holds none of the forbidden names."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from bench.harness import cell as C, runner\n"
        "import bench.drivers.serve, bench.drivers.train\n"
        "from repro_torch.runtime import batcher, steps, compiled_step\n"
        "from repro_torch.optim import adamw\n"
        "import json\n"
        "spec = json.load(open(%r))\n"
        "for m in spec['per_layer']: C.reader(m['name'])\n"
        "print(runner.forbidden_modules())\n") % (
            str(ROOT), str(ROOT / "src"), str(ROOT / "BENCHMARK.json"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
