"""The import fence: nothing under bench/ imports JAX or the JAX package
(top-level names compared whole: ``repro_torch`` is not ``repro``), and
the plain references import nothing of the program."""
import ast

import pytest

from bench import harness

FILES = sorted(p for p in harness.BENCH.rglob("*.py")
               if "__pycache__" not in p.parts)


def imported(path):
    """Top-level names of every module `path` imports."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_no_jax_anywhere(path):
    assert not imported(path) & set(harness.FORBIDDEN)


def test_references_import_nothing_of_the_program():
    for path in sorted((harness.BENCH / "reference").glob("*.py")):
        names = imported(path)
        assert "repro_torch" not in names, path
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.startswith("bench"):
                assert node.module.startswith("bench.reference"), path


def test_forbidden_modules_compares_whole_names():
    held = ["repro_torch", "repro_torch.models", "jaxlike", "flaxen.x",
            "numpy"]
    assert harness.forbidden_modules(held) == []
    assert harness.forbidden_modules(held + ["repro.core", "jax.numpy"]) \
        == ["jax", "repro"]
    assert isinstance(harness.forbidden_modules(), list)
