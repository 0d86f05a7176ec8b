"""The run's guard against JAX: no module of `jax`, `jaxlib`, `flax` or the
JAX package `halo2_tpu` may be loaded.  Names are compared by their
top-level part (before the first dot) as a whole, so the port
`halo2_tpu_torch` is not taken for `halo2_tpu`."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "halo2_tpu"})


def forbidden_loaded(names: Iterable[str] = None) -> List[str]:
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
