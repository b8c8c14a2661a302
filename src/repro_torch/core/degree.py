"""Dynamic parallelism-degree control — the ``omp_set_num_threads`` analogue
(paper §IV).

The paper's generated subroutines do::

    call omp_set_num_threads ( NumThread )   ! tuned degree, on entry
    <candidate code>
    call omp_set_num_threads ( 32 )          ! restore user maximum, on exit

On the card a degree is the number of CTAs the directive loop is split
over (:func:`repro_torch.core.exchange.launch_shape`; the H100's 132 SMs
play the part of the FX100 node's 32 cores, docs/design.md §2).  What
carries over exactly is the *protocol*: a region-scoped degree that is set
on entry and restored on exit, tuned per region, and cheap to switch
because every candidate is a launch shape of one compiled kernel.

:class:`DegreeController` implements that protocol; the Fig. 12 experiment
(:mod:`repro_torch.apps.paper_figures`) uses it.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, Iterator, Optional


class DegreeController:
    """Region-scoped parallelism degree with OpenMP set/restore semantics."""

    def __init__(self, max_degree: int) -> None:
        if max_degree < 1:
            raise ValueError("max_degree must be >= 1")
        self.max_degree = int(max_degree)
        self._current = self.max_degree
        self._tuned: Dict[str, int] = {}
        self._lock = threading.Lock()
        self.switch_count = 0  # Fig-12 accounting: how often we switched

    @property
    def current(self) -> int:
        return self._current

    def set_tuned(self, region_name: str, degree: int) -> None:
        """Record the tuned degree for a region (from the before-execution AT)."""
        if not (1 <= degree <= self.max_degree):
            raise ValueError(
                f"degree {degree} outside [1, {self.max_degree}] for {region_name!r}"
            )
        with self._lock:
            self._tuned[region_name] = int(degree)

    def tuned(self, region_name: str) -> Optional[int]:
        return self._tuned.get(region_name)

    @contextmanager
    def region(self, region_name: str) -> Iterator[int]:
        """``omp_set_num_threads(NumThread) ... omp_set_num_threads(max)``.

        Enter: switch to the region's tuned degree (or keep max if untuned).
        Exit: restore the user's maximum.  Reentrant-safe via restore-to-max
        exactly as the paper's generated code does (it restores 32, not the
        previous value).
        """
        degree = self._tuned.get(region_name, self.max_degree)
        with self._lock:
            if degree != self._current:
                self.switch_count += 1
            self._current = degree
        try:
            yield degree
        finally:
            with self._lock:
                if self._current != self.max_degree:
                    self.switch_count += 1
                self._current = self.max_degree
