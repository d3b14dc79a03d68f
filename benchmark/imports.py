"""What the benchmark's processes may not load: JAX, its runtime, flax and
the JAX package. Names are compared whole by their top-level part (before
the first dot), so ``vae_training_tpu_torch`` is not ``vae_training_tpu``."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "vae_training_tpu")
PROGRAM = "vae_training_tpu_torch"


def top_level(names: Iterable[str]) -> set:
    return {n.split(".", 1)[0] for n in names}


def forbidden_loaded(names: Iterable[str] = None) -> List[str]:
    """The forbidden top-level names among ``names`` (``sys.modules``)."""
    tops = top_level(sys.modules if names is None else names)
    return sorted(t for t in FORBIDDEN if t in tops)
