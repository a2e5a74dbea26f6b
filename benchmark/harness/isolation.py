"""The benchmark's isolation: no module of JAX, flax or the JAX package
is loaded in a run, compared by whole top-level names (``mssvt_tpu_torch``
begins with ``mssvt_tpu`` and is allowed)."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "mssvt_tpu")


def forbidden_loaded(modules=None):
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))
