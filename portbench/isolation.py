"""What the run must not have loaded: JAX and the JAX package.

Modules are compared by their top-level name (the part before the first
dot) as a whole, so the port ``repro_torch`` never matches ``repro``.
"""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_loaded(modules=None) -> list[str]:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)
