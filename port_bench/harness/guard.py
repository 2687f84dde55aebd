"""The check that the process measured nothing of JAX: no module whose
top-level name (the part before the first dot) is JAX's, its libraries',
the JAX package's or bench.py's. The port's name begins with the JAX
package's, so names are compared whole."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "soft_robot_control_tpu", "bench")


def forbidden_modules(modules=None) -> list:
    """Sorted names of loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
