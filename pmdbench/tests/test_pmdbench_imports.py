"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program either: each import's top-level
name, the part before the first dot, compared whole."""

import ast
import os

from conftest import ROOT

HERE = os.path.join(ROOT, "pmdbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "localmd_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield node.args[0].value


def _modules(sub=""):
    top = os.path.join(HERE, sub)
    for dirpath, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_module_imports_jax_or_the_jax_package():
    found = [(p, m) for p in _modules() for m in _imports(p) if m.split(".")[0] in FORBIDDEN]
    assert not found
    assert sum(1 for _ in _modules()) > 20


def test_the_reference_imports_nothing_of_the_program():
    allowed = {"torch", "numpy", "math", "contextlib", "__future__"}
    for path in _modules("reference"):
        for m in _imports(path):
            top = m.split(".")[0]
            assert top != "localmd_tpu_torch" and top in allowed, (path, m)


def test_whole_names_are_compared():
    assert "localmd_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "localmd_tpu.ops".split(".")[0] in FORBIDDEN
