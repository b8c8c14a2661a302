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
hit it in part), and the stream stays busy for :data:`SPIN_S` while the
host enqueues the launch, so the start event does not time the wrapper's
Python.  The drift watch's sampled calls (:func:`sampled_call`) keep the
stream busy just as long, so a sample and the recorded final it is held
against are taken on one yardstick; a sample whose enqueue outlasted the
spin is dropped, since its events may hold host time.

:class:`AdaptiveWallClockCost`'s ``lock``, when given (:func:`timing_lock`
of the card), is held over a point's launches and timed runs, flush
included: two searches on one card (a fleet's thread workers) would
otherwise time each other's kernels between their events and flush the L2
under them.  Building a candidate stays outside it.  The lock counts its
windows, so a caller that times a span of its own on the host clock (the
Server's steps) can tell whether a trial ran inside it.

The JAX package's compile-only costs (``CompiledRooflineCost``,
``MemoryCost``, ``roofline_from_compiled``) read XLA HLO and have no
counterpart here.  The dry-run's three-term roofline
(:class:`RooflineTerms`) is filled from a step traced on fake tensors
instead (:func:`roofline_from_trace`, over an H100 cluster's
:class:`~repro_torch.core.arch.ArchSpec`).
"""
from __future__ import annotations

import contextlib
import gc
import math
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch


@dataclass
class RooflineTerms:
    """The three roofline terms, in seconds, for one traced candidate (the
    JAX package's fields and ``asdict`` keys; ``hlo_*`` name the totals
    over every device of the mesh, as the JAX ones do)."""

    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    per_device_hbm_bytes: float = 0.0
    collective_breakdown: Dict[str, int] = field(default_factory=dict)

    @property
    def total_s(self) -> float:
        """Roofline lower bound: terms overlap perfectly, so cost = max."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    def asdict(self) -> Dict[str, Any]:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "total_s": self.total_s,
            "bottleneck": self.bottleneck,
            "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes,
            "collective_bytes": self.collective_bytes,
            "per_device_hbm_bytes": self.per_device_hbm_bytes,
            "collective_breakdown": dict(self.collective_breakdown),
        }


# Ring-model execution factors: an all-reduce moves ~2× its payload per
# device ((k-1)/k reduce-scatter + (k-1)/k all-gather); others ~1×.
_COLLECTIVE_EXEC_FACTOR = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


def link_bandwidth(ranks: Sequence[int], arch: Any) -> float:
    """Bytes/s a device moves in a collective over ``ranks``: NVLink while
    the group stays inside one node of ``arch.gpus_per_node`` GPUs (ranks
    numbered node by node), the inter-node port once it spans two."""
    nodes = {r // arch.gpus_per_node for r in ranks}
    return arch.nvlink_bandwidth if len(nodes) <= 1 else arch.internode_bandwidth


def roofline_from_trace(trace: Any, n_chips: int, arch: Any,
                        per_device_hbm_bytes: float = 0.0) -> RooflineTerms:
    """The three terms of one device's traced step
    (:class:`~repro_torch.distributed.trace.StepTrace`) on ``arch``:

    * compute    = the device's FLOPs / the bf16 dense peak;
    * memory     = the device's bytes / HBM bandwidth;
    * collective = Σ factor × payload / the group's link rate, all-reduce
      weighted 2× (ring model), a group that spans nodes at the inter-node
      rate.

    ``hlo_*`` and the breakdown report the totals over ``n_chips`` devices
    (every device runs the same step), as the JAX terms do."""
    coll_s = 0.0
    for kind, nbytes, ranks in trace.collective_calls:
        coll_s += _COLLECTIVE_EXEC_FACTOR.get(kind, 1.0) * nbytes / link_bandwidth(ranks, arch)
    coll_bytes = float(sum(trace.collectives.values()))
    return RooflineTerms(
        compute_s=trace.flops / arch.peak_flops,
        memory_s=trace.bytes / arch.hbm_bandwidth,
        collective_s=coll_s,
        hlo_flops=trace.flops * n_chips,
        hlo_bytes=trace.bytes * n_chips,
        collective_bytes=coll_bytes * n_chips,
        per_device_hbm_bytes=float(per_device_hbm_bytes),
        collective_breakdown={k: int(v * n_chips) for k, v in trace.collectives.items()},
    )


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


# Seconds the stream is kept busy before a timed run: longer than the host
# takes to enqueue one (a wrapper's Python and launch, called through a
# region, took 0.08-0.40 ms on an H100's host, once 1.09 ms:
# scripts/spin_probe.py), so the start event is reached after the run is
# enqueued and the events time the device alone.
SPIN_S = 1e-3


class TimingLock:
    """A device's timing lock: re-entrant, and it counts the windows it has
    opened, so :meth:`mark` and :meth:`quiet_since` tell a caller whether a
    timed window was open at any moment of a span of its own."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._guard = threading.Lock()
        self._depth = 0    # nesting of the owner's acquires
        self._windows = 0  # outermost acquires so far

    def acquire(self, blocking: bool = True) -> bool:
        if not self._lock.acquire(blocking):
            return False
        with self._guard:
            self._depth += 1
            if self._depth == 1:
                self._windows += 1
        return True

    def release(self) -> None:
        with self._guard:
            self._depth -= 1
        self._lock.release()

    def __enter__(self) -> "TimingLock":
        self.acquire()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.release()

    def mark(self) -> tuple:
        """(windows opened so far, whether one is open now)."""
        with self._guard:
            return self._windows, self._depth > 0

    def quiet_since(self, mark: tuple) -> bool:
        """Whether no window was open at ``mark`` or has opened since."""
        return not mark[1] and self.mark() == mark


_TIMING_LOCKS: Dict[str, TimingLock] = {}
_TIMING_LOCKS_GUARD = threading.Lock()


def timing_lock(device: Any) -> TimingLock:
    """The one lock of ``device`` that every timed window on it holds.

    Process-wide because the card is: any two costs timing on one device
    must exclude each other, whoever built them.  Re-entrant, because a
    measured composite (a train step) may tune a kernel inside its run.
    """
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = str(device)
    with _TIMING_LOCKS_GUARD:
        lock = _TIMING_LOCKS.get(key)
        if lock is None:
            lock = _TIMING_LOCKS[key] = TimingLock()
    return lock


class CostFunction:
    """cost(PP point) -> float seconds (lower is better)."""

    def __call__(self, point: Mapping[str, Any]) -> float:  # pragma: no cover
        raise NotImplementedError


def timed_call(
    fn: Callable[[], Any], prepare: Optional[Callable[[], Any]] = None
) -> Tuple[Any, float]:
    """One run of ``fn``: (its output, seconds).  CUDA events when it
    returns CUDA tensors, else the host clock around a synchronised run.

    The collector waits until the run is enqueued: a collection inside the
    window would leave the stream idle between the events.
    """
    if prepare is not None:
        prepare()
    start = end = None
    if torch.cuda.is_available():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
    collecting = gc.isenabled()
    gc.disable()
    try:
        if start is not None:
            start.record()
        t0 = time.perf_counter()
        out = fn()
        if start is not None and _is_cuda(out):
            end.record()
    finally:
        if collecting:
            gc.enable()
    if start is not None and _is_cuda(out):
        end.synchronize()
        return out, start.elapsed_time(end) / 1e3
    _block(out)
    return out, time.perf_counter() - t0


def sampled_call(fn: Callable[[], Any], device: Any) -> Tuple[Any, Optional[float]]:
    """One run of ``fn`` after :func:`spin` on ``device``: (its output,
    seconds by CUDA events), or (its output, None) where the stream may
    have waited on the host between the events.

    The spin covers the host's enqueue only while it lasts.  If the start
    event has completed by the time the end event is enqueued, the host was
    still enqueueing when the stream reached the start (a slow wrapper, a
    preempted thread, another thread holding the interpreter), and the
    stream may have idled inside the window: the time is not the device's
    alone.  If it has not, the stream was still spinning after the whole
    run was enqueued, and the events time the device alone.
    """
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    busy = spin(device)
    collecting = gc.isenabled()
    gc.disable()
    try:
        busy()
        start.record()
        t0 = time.perf_counter()
        out = fn()
        if not _is_cuda(out):
            _block(out)
            return out, time.perf_counter() - t0
        end.record()
        covered = not start.query()
    finally:
        if collecting:
            gc.enable()
    end.synchronize()
    return out, start.elapsed_time(end) / 1e3 if covered else None


def _timed(fn: Callable[[], Any], prepare: Optional[Callable[[], Any]]) -> float:
    """Seconds one run of ``fn`` takes (:func:`timed_call`)."""
    return timed_call(fn, prepare)[1]


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
        lock: Optional[threading.RLock] = None,
    ) -> None:
        self.build = build
        self.warmup = warmup
        self.min_repeats = max(1, min_repeats)
        self.max_repeats = max(self.min_repeats, max_repeats)
        self.rel_margin = rel_margin
        self.confidence = confidence
        self.prepare = prepare
        self.lock = lock
        self.incumbent = math.inf
        self.timed_runs = 0
        self.measured_points = 0

    def __call__(
        self, point: Mapping[str, Any], budget: Optional[int] = None
    ) -> float:
        fn = self.build(point)
        with self.lock or contextlib.nullcontext():
            return self._measure(fn, budget)

    def _measure(self, fn: Callable[[], Any], budget: Optional[int]) -> float:
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


def spin(device: Any) -> Callable[[], Any]:
    """A ``prepare`` hook that keeps ``device``'s stream busy for
    :data:`SPIN_S`, so the host enqueues the timed call before the stream
    reaches the start event and the events time the device alone, not the
    wrapper's Python."""
    clock_khz = torch.cuda.get_device_properties(device).clock_rate or 2_000_000
    cycles = int(SPIN_S * clock_khz * 1e3)
    return lambda: torch.cuda._sleep(cycles)


def l2_flush(device: Any, nbytes: int) -> Callable[[], Any]:
    """A ``prepare`` hook for timing one call on ``device`` cold: it evicts
    the L2 by zeroing ``nbytes`` of scratch (pass at least the card's L2
    size), then keeps the stream busy as :func:`spin` does."""
    scratch = torch.empty(max(1, nbytes // 4), dtype=torch.int32, device=device)
    busy = spin(device)

    def prepare() -> None:
        scratch.zero_()
        busy()

    return prepare
