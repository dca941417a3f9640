"""The modules a run may not hold: JAX and its packages, and the JAX
package the port was made from, compared by whole top-level names."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "pathintegralgroundstate_tpu"})


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level names among the loaded modules."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)
