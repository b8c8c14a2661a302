"""The readings a cell's limits are set from: the program's on many seeds
(the lower reading), and the control's and the planted faults' (the upper).

Each job kind's runner takes them (``readings`` of :mod:`harness.train`,
:mod:`harness.serve`), its program through the same set-up as a timed run
(the runner's ``setup``).  ``bench/calibrate.py`` runs them on the card at
the cell's own size.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List

from .cell import cache_dir, runner_of
from .manifest import Cell


def readings(cell: Cell, seeds: Iterable[int], control_seeds: Iterable[int], device,
             say: Callable[[str], None] = print, cache=None) -> List[Dict[str, Any]]:
    """One row a seed: the program's numbers, and on ``control_seeds`` the
    control's and each fault's (``cache``: the cell's cache directory by
    default)."""
    return runner_of(cell).readings(cell, seeds, control_seeds, device,
                                    cache if cache is not None else cache_dir(cell), say)


def summary(rows: List[Dict[str, Any]]) -> Dict[str, Dict[str, float]]:
    """Per number compared: the largest program reading (the lower one) and
    the smallest reading of the control and of each fault (the upper ones)."""
    out: Dict[str, Dict[str, float]] = {}
    for row in rows:
        for kind in ("program", "control", "half_batch", "unchanged"):
            for name, v in row.get(kind, {}).items():
                d = out.setdefault(name, {})
                key = "lower" if kind == "program" else kind
                if kind == "program":
                    d[key] = max(d.get(key, 0.0), v)
                else:
                    d[key] = min(d.get(key, float("inf")), v)
    return out
