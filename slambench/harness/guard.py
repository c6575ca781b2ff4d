"""The import guard: nothing a run loads may be JAX or the JAX package.

Modules are compared by their top-level name (the part before the first
dot), whole: `movslam_tpu_torch` is the port and passes, `movslam_tpu` is
the JAX package and fails.
"""
from __future__ import annotations

import sys

BANNED = frozenset({"jax", "jaxlib", "flax", "movslam_tpu"})


def banned_modules(modules=None):
    """Sorted top-level names of loaded modules that the benchmark refuses."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & BANNED)
