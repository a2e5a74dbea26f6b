"""No module of JAX, flax or the JAX package in the benchmark, and no
module of the port in the reference (top-level names compared whole)."""

import ast

import pytest

from benchmark.harness import isolation, spec


def imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def tops(paths):
    return {name.split(".")[0] for p in paths for name in imports(p)}


def test_reference_imports_nothing_of_the_port():
    found = tops((spec.BENCH / "reference").rglob("*.py"))
    assert not found & {"mssvt_tpu_torch", "mssvt_tpu", "jax", "jaxlib",
                        "flax"}, found


def test_benchmark_imports_no_jax():
    found = tops(spec.BENCH.rglob("*.py"))
    assert not found & set(isolation.FORBIDDEN), found
    assert "mssvt_tpu_torch" in found  # the harness drives the port


@pytest.mark.parametrize("mods,want", [
    (["torch", "mssvt_tpu_torch.models", "numpy"], []),
    (["mssvt_tpu.ops", "torch"], ["mssvt_tpu"]),
    (["jax._src.core", "jaxlib", "flax.linen"], ["flax", "jax", "jaxlib"]),
    (["jaxtyping", "mssvt_tpu_torchx"], []),
])
def test_forbidden_by_whole_top_level_name(mods, want):
    assert isolation.forbidden_loaded(mods) == want
