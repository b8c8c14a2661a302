"""The guard that no run measures the JAX package.

A module counts by its top-level name, the part of its name before the
first dot, compared whole: ``repro_torch`` is the program, ``repro`` is
the JAX package it was ported from.
"""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """The forbidden top-level names among ``names`` (the loaded modules by
    default), sorted."""
    names = sys.modules if names is None else names
    found = {n.split(".", 1)[0] for n in names} & set(FORBIDDEN)
    return sorted(found)
