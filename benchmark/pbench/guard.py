"""The import guard: no module of JAX, of Flax or of the JAX package
(pbrt_tpu) may be loaded in a run's process. Top-level names are
compared whole, so the port (pbrt_tpu_torch) passes."""
from __future__ import annotations

import sys

BANNED = frozenset({"jax", "jaxlib", "flax", "pbrt_tpu"})


def banned_modules(modules=None):
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & BANNED)
