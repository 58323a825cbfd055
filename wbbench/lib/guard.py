"""The import guard: nothing that runs on the card may load JAX or the JAX package."""

from __future__ import annotations

import sys

#: top-level module names that may not be loaded (compared whole: the port
#: ``whitebox_tpu_torch`` begins with ``whitebox_tpu`` and passes)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "whitebox_tpu"})


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name (the part before the first dot) is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in list(names) if n.split(".", 1)[0] in FORBIDDEN)
