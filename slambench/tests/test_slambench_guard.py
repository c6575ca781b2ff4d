"""The import guard compares whole top-level names."""
import ast
import pathlib

import pytest

from harness import guard


@pytest.mark.parametrize("loaded,found", [
    (["movslam_tpu_torch", "movslam_tpu_torch.ops.kernels", "numpy", "jaxtyping"], []),
    (["movslam_tpu", "numpy"], ["movslam_tpu"]),
    (["movslam_tpu.ops.ba"], ["movslam_tpu"]),
    (["jax", "jax.numpy"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen", "movslam_tpu_torch"], ["flax"]),
])
def test_banned_modules(loaded, found):
    assert guard.banned_modules(loaded) == found


def test_benchmark_sources_import_no_banned_module():
    """No file of the benchmark outside its tests names JAX or the JAX package
    in an import (the run's own check is on sys.modules)."""
    bench = pathlib.Path(guard.__file__).resolve().parent.parent
    for path in bench.rglob("*.py"):
        if "tests" in path.parts:
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else (
                [node.module or ""] if isinstance(node, ast.ImportFrom) and node.level == 0 else [])
            assert not guard.banned_modules(names), (path, names)
