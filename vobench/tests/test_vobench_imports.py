"""No module of the benchmark has JAX or the JAX package as its top-level
import, the reference imports nothing of the program, and only
``vobench/program.py`` imports the program."""

import ast
import os
import subprocess
import sys

from vobench import manifest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = {"jax", "jaxlib", "flax", "tpuvo"}


def _modules():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_anywhere():
    for path in _modules():
        assert not (set(_imports(path)) & JAX), path


def test_only_the_adapter_imports_the_program():
    for path in _modules():
        rel = os.path.relpath(path, HERE)
        if "tpuvo_torch" in set(_imports(path)):
            assert rel == "program.py" or rel.startswith("tests"), rel


def test_reference_and_check_load_without_the_program():
    code = ("import sys; import vobench.check, vobench.control, vobench.reference.run; "
            "bad = {m.split('.')[0] for m in sys.modules} & {'tpuvo_torch', 'tpuvo', 'jax'}; "
            "print(sorted(bad))")
    out = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT, capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from vobench import run

    monkeypatch.setitem(sys.modules, "tpuvo_torch_fake", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "tpuvo.fake", object())
    assert run.forbidden_modules() == ["tpuvo"]
