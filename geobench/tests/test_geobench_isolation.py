"""Nothing under geobench imports JAX or the JAX package, compared by whole
top-level names (the port's name begins with the JAX package's), and the
reference's modules import nothing of the port."""

import ast

import pytest

from geobench import harness

REFERENCE_SIDE = ("reference.py", "judge.py", "inputs.py", "work.py")


def _imports(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif (isinstance(node, ast.ImportFrom) and node.module
              and not node.level):
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "")
              == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(p for p in harness.HERE.rglob("*.py")
                 if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_jax_anywhere(path):
    assert not _imports(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("name", REFERENCE_SIDE)
def test_reference_side_imports_nothing_of_the_port(name):
    names = _imports(harness.HERE / name)
    assert "vae_latent_geometry_tpu_torch" not in names
    assert not names & set(harness.FORBIDDEN)


def test_the_check_is_not_a_prefix_match():
    # the port's name starts with the JAX package's
    assert "vae_latent_geometry_tpu_torch".startswith(
        "vae_latent_geometry_tpu")
    assert "vae_latent_geometry_tpu_torch" not in harness.FORBIDDEN


def test_nothing_reads_the_jax_benchmark():
    for path in SOURCES:
        text = path.read_text()
        for name in ("bench.py", "bench_details", "BENCH_r0", "BASELINE."):
            if path.name == "test_geobench_isolation.py":
                continue
            assert name not in text, (path, name)
