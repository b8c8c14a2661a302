"""Structured tracing: nested spans, a ring-buffer flight recorder, and
deterministic Chrome/Perfetto ``trace_event`` JSON export.

Design constraints (docs/observability.md):

* **Stdlib-only, no repro imports** — core modules (tuner, engine, fleet)
  import this module, so it must sit below everything else in the import
  graph.
* **Zero-cost when disabled** — instrumented seams guard with
  ``tr = current_tracer()`` / ``if tr is not None`` and the dispatch fast
  path (:meth:`AutotunedOp.__call__`) carries *no* tracer code at all; the
  guard lives only on slow paths.  The ``bench_dispatch`` >=10x gate and the
  ``obs_overhead`` <=2% gate in ``benchmarks/`` enforce this.
* **Deterministic export** — the clock is injectable (the engine passes its
  virtual clock / a :class:`TickTimer`), timestamps are rounded to integer
  microseconds, and :meth:`Tracer.to_json` sorts events and track-ids
  canonically so the same run produces byte-identical trace files.

Span timestamps are *seconds* at the API (matching ``time.perf_counter``
and the engine's virtual ``now``); export converts to the integer
microseconds Perfetto expects.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Optional

__all__ = [
    "Tracer",
    "TickTimer",
    "current_tracer",
    "set_tracer",
    "use_tracer",
]


def _us(t: float) -> int:
    """Seconds -> integer microseconds (deterministic across platforms)."""
    return int(round(float(t) * 1e6))


def _jsonable(value: Any) -> Any:
    """Coerce span attrs to JSON-safe, deterministic values."""
    if value is None or isinstance(value, (bool, int, str)):
        return value
    if isinstance(value, float):
        # round-trip-stable and finite-only: Perfetto JSON has no Infinity
        if value != value or value in (float("inf"), float("-inf")):
            return repr(value)
        return value
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    if isinstance(value, dict):
        return {str(k): _jsonable(v) for k, v in value.items()}
    return str(value)


class TickTimer:
    """Deterministic stand-in for ``time.perf_counter``: the n-th call
    returns ``n * tick_s``.  Injected into the engine (``timer=``) so a
    seeded chaos trace produces byte-identical virtual-clock timelines —
    every measured step costs exactly one tick regardless of host speed."""

    def __init__(self, tick_s: float = 1e-3):
        self.tick_s = float(tick_s)
        self.n = 0
        self._lock = threading.Lock()

    def __call__(self) -> float:
        with self._lock:
            self.n += 1
            return self.n * self.tick_s


class Tracer:
    """Process-local tracer with a bounded flight recorder.

    Events live in a ring buffer (``capacity`` newest events are kept, the
    ``dropped`` counter records overflow) so an always-on tracer has bounded
    memory.  Two emission styles:

    * :meth:`span` — context manager stamping ``clock()`` at enter/exit
      (wall-time instrumentation: tuner trials, fleet RPCs, background jobs).
    * :meth:`complete` / :meth:`instant` — explicit timestamps for code that
      owns its own clock (the streaming engine's virtual ``now``).
    """

    def __init__(
        self,
        clock: Callable[[], float] = time.perf_counter,
        capacity: int = 65536,
    ):
        self.clock = clock
        self.capacity = int(capacity)
        self._events: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self.emitted = 0

    # -- emission ----------------------------------------------------------

    def _emit(self, ev: Dict[str, Any]) -> None:
        with self._lock:
            self.emitted += 1
            self._events.append(ev)

    @property
    def dropped(self) -> int:
        return self.emitted - len(self._events)

    def _track(self, track: Optional[str]) -> str:
        return track if track is not None else threading.current_thread().name

    @contextmanager
    def span(
        self, name: str, cat: str = "", track: Optional[str] = None, **attrs: Any
    ) -> Iterator[Dict[str, Any]]:
        """Record a complete span around the with-block.  Yields the attrs
        dict so the body can attach results (cost, verdict, ...) before the
        span closes.  Nesting is positional: spans closed LIFO on one thread
        render as a properly nested flame on that thread's track."""
        t0 = self.clock()
        args = dict(attrs)
        try:
            yield args
        finally:
            self.complete(name, t0, self.clock(), cat=cat, track=track, **args)

    def complete(
        self,
        name: str,
        t0: float,
        t1: float,
        cat: str = "",
        track: Optional[str] = None,
        **attrs: Any,
    ) -> None:
        """Explicit-timestamp complete ("X") event; ``t0``/``t1`` seconds."""
        ts = _us(t0)
        self._emit({
            "ph": "X", "name": str(name), "cat": str(cat), "ts": ts,
            "dur": max(0, _us(t1) - ts), "track": self._track(track),
            "args": _jsonable(attrs),
        })

    def instant(
        self,
        name: str,
        t: Optional[float] = None,
        cat: str = "",
        track: Optional[str] = None,
        **attrs: Any,
    ) -> None:
        """Point-in-time ("i") event; ``t`` defaults to ``clock()``."""
        self._emit({
            "ph": "i", "name": str(name), "cat": str(cat),
            "ts": _us(self.clock() if t is None else t),
            "track": self._track(track), "args": _jsonable(attrs),
        })

    # -- inspection / export ----------------------------------------------

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(e) for e in self._events]

    def summary(self) -> Dict[str, int]:
        """Event counts keyed ``track/name`` — the span-taxonomy view."""
        out: Dict[str, int] = {}
        for e in self.events():
            key = f"{e['track']}/{e['name']}"
            out[key] = out.get(key, 0) + 1
        return dict(sorted(out.items()))

    def trace_events(self) -> List[Dict[str, Any]]:
        """Chrome ``trace_event`` array, canonically ordered.

        Track names are mapped to tids in sorted order and events are
        sorted by (ts, tid, name, canonical-json) so export is a pure
        function of the event *set* — thread interleaving during capture
        cannot change the output bytes."""
        evs = self.events()
        tracks = sorted({e["track"] for e in evs})
        tid = {t: i + 1 for i, t in enumerate(tracks)}
        out: List[Dict[str, Any]] = []
        for e in evs:
            d: Dict[str, Any] = {
                "name": e["name"], "cat": e["cat"] or "repro", "ph": e["ph"],
                "ts": e["ts"], "pid": 1, "tid": tid[e["track"]],
                "args": e["args"],
            }
            if e["ph"] == "X":
                d["dur"] = e["dur"]
            elif e["ph"] == "i":
                d["s"] = "t"
            out.append(d)
        out.sort(key=lambda d: (
            d["ts"], d["tid"], d["name"],
            json.dumps(d, sort_keys=True, default=str),
        ))
        meta = [
            {"name": "thread_name", "ph": "M", "pid": 1, "tid": tid[t],
             "args": {"name": t}}
            for t in tracks
        ]
        return meta + out

    def to_json(self) -> str:
        return json.dumps(
            {"displayTimeUnit": "ms", "traceEvents": self.trace_events()},
            sort_keys=True, separators=(",", ":"),
        )

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())


# -- process-global tracer (the instrumentation guard) ----------------------

_ACTIVE: Optional[Tracer] = None


def current_tracer() -> Optional[Tracer]:
    """The installed tracer, or ``None`` when tracing is disabled.  Every
    instrumented seam guards on this — when it returns ``None`` the cost is
    one global load + one comparison, off every hot dispatch path."""
    return _ACTIVE


def set_tracer(tracer: Optional[Tracer]) -> Optional[Tracer]:
    """Install (or, with ``None``, remove) the process tracer; returns the
    previous one so callers can restore it."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = tracer
    return prev


@contextmanager
def use_tracer(tracer: Optional[Tracer]) -> Iterator[Optional[Tracer]]:
    prev = set_tracer(tracer)
    try:
        yield tracer
    finally:
        set_tracer(prev)
