"""The benchmark's import guard: the JAX stack and the JAX package stay out.

Names are compared by their whole top-level part (before the first dot),
so `qoi_tpu_torch` is not `qoi_tpu`.
"""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "qoi_tpu"})


def top(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden(names: Iterable[str]) -> List[str]:
    """The names whose top-level part is forbidden, sorted."""
    return sorted(n for n in names if top(n) in FORBIDDEN)


def loaded_forbidden() -> List[str]:
    """Forbidden modules in this process's sys.modules."""
    return forbidden(list(sys.modules))


class Blocker:
    """A meta path finder that refuses to import forbidden modules (for
    the tests' import check)."""

    def find_spec(self, fullname, path=None, target=None):
        if top(fullname) in FORBIDDEN:
            raise ImportError(f"import of {fullname} is blocked")
        return None
