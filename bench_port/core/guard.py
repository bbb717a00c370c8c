"""The modules a run may not hold: JAX and the JAX package the port was made
from. Names are compared whole, by their top-level part: the port's own
`recsys_examples_torch` begins with the JAX package's name and is allowed."""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "recsys_examples_tpu")


def forbidden_loaded(modules: Iterable[str] = None) -> List[str]:
    """The loaded module names whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
