"""FIBER cost-definition functions (paper §II.A), measured on the device.

The cost definition function maps a PP assignment to a scalar cost with BP
fixed.  The paper uses measured execution time; so does the port, because
the card it tunes for is the card it runs on:

* :class:`WallClockCost` — fixed repeats, minimum time.
* :class:`AdaptiveWallClockCost` — variance-aware repeats that stop once a
  candidate separates from the incumbent.

On a CUDA output both time the device with CUDA events instead of the host
clock (a launch returns before the kernel ends).  ``prepare``, when given,
runs untimed before every timed run and is *not* synchronised: the port
passes :func:`l2_flush` there, so each run finds its inputs cold (exb's
working set, 55.4 MB, is larger than the H100's 50 MB L2 but would still
hit it in part), and the stream stays busy while the host enqueues the
launch, so the start event does not time the wrapper's Python.

The JAX package's compile-only costs (``CompiledRooflineCost``,
``MemoryCost``, ``roofline_from_compiled``) read XLA HLO and have no
counterpart here.
"""
from __future__ import annotations

import math
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, List, Mapping, Optional, Sequence

import torch


def score_points_concurrently(
    score_one: Callable[[Mapping[str, Any]], float],
    points: Sequence[Mapping[str, Any]],
    max_workers: Optional[int] = None,
) -> List[float]:
    """Score candidates on a bounded thread pool; failures score ``inf``.

    The single shared policy for prescreen fan-out: `StagedSearch`'s
    prescreen delegates here, so the worker bound and the
    exclude-don't-fail error handling live in one place.
    """
    workers = max_workers or min(8, os.cpu_count() or 2)

    def score(p: Mapping[str, Any]) -> float:
        try:
            return float(score_one(p))
        except Exception:
            return math.inf

    if workers <= 1 or len(points) <= 1:
        return [score(p) for p in points]
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(score, points))


class CostFunction:
    """cost(PP point) -> float seconds (lower is better)."""

    def __call__(self, point: Mapping[str, Any]) -> float:  # pragma: no cover
        raise NotImplementedError


def _timed(fn: Callable[[], Any], prepare: Optional[Callable[[], Any]]) -> float:
    """Seconds one run of ``fn`` takes: CUDA events when it returns CUDA
    tensors, else the host clock around a synchronised run."""
    if prepare is not None:
        prepare()
    start = end = None
    if torch.cuda.is_available():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    out = fn()
    if start is not None and _is_cuda(out):
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    _block(out)
    return time.perf_counter() - t0


class WallClockCost(CostFunction):
    """Measured time of ``build(point)()`` — the paper's cost function.

    ``build`` maps a PP point to a zero-arg callable that runs the candidate
    once (already closed over its inputs).  Measures ``repeats`` timed runs
    after ``warmup`` untimed ones and returns the minimum (standard practice
    to suppress noise; the paper runs 1000 iterations for the same reason).
    """

    def __init__(
        self,
        build: Callable[[Mapping[str, Any]], Callable[[], Any]],
        warmup: int = 2,
        repeats: int = 5,
        prepare: Optional[Callable[[], Any]] = None,
    ) -> None:
        self.build = build
        self.warmup = warmup
        self.repeats = repeats
        self.prepare = prepare

    def __call__(self, point: Mapping[str, Any]) -> float:
        fn = self.build(point)
        for _ in range(self.warmup):
            _block(fn())
        return min(_timed(fn, self.prepare) for _ in range(self.repeats))


class AdaptiveWallClockCost(CostFunction):
    """Measured time with variance-aware adaptive repeats.

    Fixed-repeat timing spends the same budget on a candidate that is 10×
    off the incumbent as on one within noise of it.  This cost times each
    point until its confidence interval separates from the best cost seen so
    far (the *incumbent*), then stops:

    * after ``min_repeats`` timed runs, a point whose best time is already
      ``rel_margin`` above the incumbent is abandoned immediately;
    * otherwise timing continues until ``best ± halfwidth`` (a
      ``confidence``-sigma standard-error interval) no longer straddles the
      incumbent, or ``max_repeats`` is reached.

    ``supports_budget`` lets :class:`~repro_torch.core.search.SuccessiveHalving`
    pass its rung budget through: ``cost(point, budget)`` scales the repeat
    cap.  ``timed_runs`` / ``measured_points`` count the work done.
    """

    supports_budget = True

    def __init__(
        self,
        build: Callable[[Mapping[str, Any]], Callable[[], Any]],
        warmup: int = 1,
        min_repeats: int = 1,
        max_repeats: int = 4,
        rel_margin: float = 0.25,
        confidence: float = 2.0,
        prepare: Optional[Callable[[], Any]] = None,
    ) -> None:
        self.build = build
        self.warmup = warmup
        self.min_repeats = max(1, min_repeats)
        self.max_repeats = max(self.min_repeats, max_repeats)
        self.rel_margin = rel_margin
        self.confidence = confidence
        self.prepare = prepare
        self.incumbent = math.inf
        self.timed_runs = 0
        self.measured_points = 0

    def __call__(
        self, point: Mapping[str, Any], budget: Optional[int] = None
    ) -> float:
        fn = self.build(point)
        for _ in range(self.warmup):
            _block(fn())
        cap = self.max_repeats * max(1, int(budget or 1))
        times: List[float] = []
        while len(times) < cap:
            times.append(_timed(fn, self.prepare))
            self.timed_runs += 1
            if len(times) < self.min_repeats:
                continue
            best = min(times)
            if not math.isfinite(self.incumbent):
                if len(times) >= self.min_repeats + 1:
                    break  # first point: just establish the incumbent
                continue
            if best > self.incumbent * (1.0 + self.rel_margin):
                break  # clearly worse: stop paying for precision
            if len(times) >= 2:
                mean = sum(times) / len(times)
                var = sum((t - mean) ** 2 for t in times) / (len(times) - 1)
                halfwidth = self.confidence * math.sqrt(var / len(times))
                if (best + halfwidth < self.incumbent
                        or best - halfwidth > self.incumbent):
                    break  # CI separated from the incumbent either way
        cost = min(times)
        self.measured_points += 1
        self.incumbent = min(self.incumbent, cost)
        return cost


def _leaves(x: Any):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for item in x:
            yield from _leaves(item)
    elif isinstance(x, dict):
        for item in x.values():
            yield from _leaves(item)


def _is_cuda(x: Any) -> bool:
    return any(t.is_cuda for t in _leaves(x))


def _block(x: Any) -> Any:
    """Wait for ``x``: synchronise CUDA when it holds a CUDA tensor (torch
    runs eagerly on the CPU, so a CPU result is already complete)."""
    if _is_cuda(x):
        torch.cuda.synchronize()
    return x


def l2_flush(device: Any, nbytes: int, spin_s: float = 2e-4) -> Callable[[], Any]:
    """A ``prepare`` hook for timing one call on ``device`` cold.

    It evicts the L2 by zeroing ``nbytes`` of scratch (pass at least the
    card's L2 size), then keeps the stream busy for ``spin_s`` seconds, so
    the host enqueues the timed call before the stream reaches the start
    event and the events time the device alone, not the wrapper's Python.
    """
    scratch = torch.empty(max(1, nbytes // 4), dtype=torch.int32, device=device)
    clock_khz = torch.cuda.get_device_properties(device).clock_rate or 2_000_000
    cycles = int(spin_s * clock_khz * 1e3)

    def prepare() -> None:
        scratch.zero_()
        torch.cuda._sleep(cycles)

    return prepare
