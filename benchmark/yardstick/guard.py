"""The import guard: the benchmark measures the PyTorch port alone, so no
module of JAX or of the JAX package may be loaded in a run. Names are
compared by their top-level part (before the first dot) whole: the port,
``apx_torch``, is not the JAX package ``apx``."""

from __future__ import annotations

import sys

__all__ = ["FORBIDDEN", "forbidden_loaded"]

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "apx"})


def forbidden_loaded(modules=None) -> list[str]:
    """The loaded module names whose top-level name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in list(names) if m.split(".", 1)[0] in FORBIDDEN)
