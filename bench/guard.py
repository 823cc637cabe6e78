"""What the benchmark may never load: JAX, its libraries, and the JAX
package this port was made from. Names are compared by their top-level
part (before the first dot), whole: the port's `repro_torch` is not
`repro`."""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})
# the reference may not use the program either
FORBIDDEN_IN_REFERENCE = FORBIDDEN | {"repro_torch"}


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def loaded(forbidden: Iterable[str] = FORBIDDEN,
           modules: Iterable[str] = None) -> List[str]:
    """The forbidden top-level names among the modules loaded (sorted)."""
    names = sys.modules if modules is None else modules
    bad = frozenset(forbidden)
    return sorted({top_level(m) for m in names if top_level(m) in bad})
