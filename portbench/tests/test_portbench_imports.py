"""Nothing of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the program (top-level module names compared
whole: the program's name begins with the JAX package's)."""

from __future__ import annotations

import ast
import glob
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "fleetrec_tpu"}


def top_imports(path: str) -> set:
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def sources():
    return sorted(glob.glob(os.path.join(HERE, "**", "*.py"), recursive=True))


def test_no_module_imports_jax_or_the_jax_package():
    bad = {p: sorted(top_imports(p) & FORBIDDEN) for p in sources()}
    assert not {p: v for p, v in bad.items() if v}


def test_reference_imports_nothing_of_the_program():
    # the reference and the harness modules it reads (relative imports)
    for name in ("reference.py", "tables.py", "inputs.py", "yardstick.py"):
        names = top_imports(os.path.join(HERE, name))
        assert "fleetrec_tpu_torch" not in names, name
        tree = ast.parse(open(os.path.join(HERE, name)).read())
        rel = set()
        for n in ast.walk(tree):
            if isinstance(n, ast.ImportFrom) and n.level:
                rel.update([n.module] if n.module else [a.name for a in n.names])
        assert rel <= {"tables", "inputs", "yardstick"}, (name, rel)


def test_run_refuses_forbidden_modules(monkeypatch):
    import sys
    import types

    from portbench import run

    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "fleetrec_tpu.ops", types.ModuleType("fleetrec_tpu.ops"))
    assert run.forbidden_modules() == ["fleetrec_tpu"]
