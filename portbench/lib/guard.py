"""The check that nothing in this process loaded JAX or the JAX package:
the top-level name of every module (before the first dot) compared
whole, so the port, whose name begins with the JAX package's, passes."""
from __future__ import annotations

import sys
from typing import List

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded() -> List[str]:
    """The forbidden top-level names in ``sys.modules``."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)
