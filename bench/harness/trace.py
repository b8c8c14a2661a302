"""The device trace of a window, taken with ``torch.profiler``, reduced to
what the per-layer metrics and the breakdown read.

The harness labels its own calls with ``record_function`` spans named
``bench.*`` (the window, each step, the loss read, the batch copy-in, each
``serve()`` call); a device idle gap is named by the innermost of them
that the host was in.  Spans inside the program are not read here.

Kinds of device operation by kernel name (the classification of
``chip_smoke.py``'s ``STEP_KINDS``): the port's hand-written kernels by
their entry names, GEMMs by the names cuBLAS and CUTLASS give theirs, and
everything else is eager work (element-wise ops, reductions, copies,
indexing).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

WINDOW = "bench.window"
HAND_WRITTEN = {
    "flash_forward": ("flash_fwd",),
    "flash_backward": ("flash_bwd",),
    "ssm_scan_forward": ("ssm_kernel",),
    "ssm_scan_backward": ("ssm_bwd",),
    "rglru_scan_forward": ("rglru_kernel",),
    "rglru_scan_backward": ("rglru_bwd",),
}
GEMM = ("gemm", "nvjet", "xmma", "cutlass")
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass(frozen=True)
class Interval:
    name: str
    start_ns: int
    end_ns: int

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def kind_of(name: str) -> str:
    """The kind of a device operation: a hand-written kernel's kind,
    ``gemm``, or ``eager``."""
    low = name.lower()
    for kind, keys in HAND_WRITTEN.items():
        if any(k in low for k in keys):
            return kind
    if any(k in low for k in GEMM):
        return "gemm"
    return "eager"


def union_seconds(intervals: Sequence[Tuple[int, int]]) -> float:
    """Seconds covered by the union of ``(start_ns, end_ns)`` intervals."""
    busy, reach = 0, None
    for start, end in sorted(intervals):
        if reach is None or start >= reach:
            busy += end - start
            reach = end
        elif end > reach:
            busy += end - reach
            reach = end
    return busy / 1e9


@dataclass
class Trace:
    """Device operations and the harness's host spans inside one window."""

    window: Interval
    ops: List[Interval]
    spans: List[Interval] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.window.seconds

    @property
    def busy_s(self) -> float:
        return union_seconds([(o.start_ns, o.end_ns) for o in self.ops])

    def seconds_by_kind(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for o in self.ops:
            k = kind_of(o.name)
            out[k] = out.get(k, 0.0) + o.seconds
        return out

    def seconds_of(self, kind: str) -> float:
        return self.seconds_by_kind().get(kind, 0.0)

    def device_seconds(self) -> float:
        return sum(o.seconds for o in self.ops)

    def top_ops(self, n: int = 10) -> List[List]:
        """The ``n`` device operations, by name, that took most time."""
        by_name: Dict[str, float] = {}
        for o in self.ops:
            by_name[o.name] = by_name.get(o.name, 0.0) + o.seconds
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], sec] for name, sec in top]

    def gaps(self) -> List[Interval]:
        """The device's idle intervals inside the window."""
        out, reach = [], self.window.start_ns
        for o in sorted(self.ops, key=lambda o: o.start_ns):
            if o.start_ns > reach:
                out.append(Interval("idle", reach, o.start_ns))
            reach = max(reach, o.end_ns)
        if self.window.end_ns > reach:
            out.append(Interval("idle", reach, self.window.end_ns))
        return out

    def host_label(self, gap: Interval) -> str:
        """The innermost harness span the host was in for most of ``gap``,
        or ``bench.window`` where it was outside every other span longer."""
        best, best_key, covered = WINDOW, None, []
        for s in self.spans:
            lo, hi = max(s.start_ns, gap.start_ns), min(s.end_ns, gap.end_ns)
            if hi <= lo:
                continue
            covered.append((lo, hi))
            key = (hi - lo, -(s.end_ns - s.start_ns))  # most overlap, then innermost
            if best_key is None or key > best_key:
                best, best_key = s.name, key
        outside = (gap.end_ns - gap.start_ns) - union_seconds(covered) * 1e9
        if best_key is None or outside > best_key[0]:
            return WINDOW
        return best

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The ``n`` longest idle gaps, each named by what the host was doing."""
        gaps = sorted(self.gaps(), key=lambda g: -(g.end_ns - g.start_ns))[:n]
        return [[self.host_label(g), g.seconds] for g in gaps]

    def breakdown(self) -> Dict[str, List[List]]:
        return {"device_ops": self.top_ops(), "idle_gaps": self.idle_gaps()}


def _events(prof) -> List:
    """The profiler's raw events (without building its per-op summaries,
    which take minutes over a window of a million events)."""
    results = getattr(prof.profiler, "kineto_results", None)
    if results is None:
        raise RuntimeError("torch.profiler returned no kineto results")
    return list(results.events())


def _device_op(e) -> bool:
    """True for a kernel, copy or fill on the device; False for a range a
    ``record_function`` label opened on the device's timeline.  Torch
    versions that give events no activity type mark the labels as user
    annotations."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind() in DEVICE_ACTIVITIES
    if getattr(e, "is_user_annotation", None) is not None and e.is_user_annotation():
        return False
    return not e.name().startswith("bench.")


def reduce(prof) -> Trace:
    """The :class:`Trace` of the ``bench.window`` span in a finished
    profile: device operations clipped to it, and the ``bench.*`` spans."""
    from torch.autograd import DeviceType

    ops, spans, window = [], [], None
    for e in _events(prof):
        start, end = int(e.start_ns()), int(e.end_ns())
        if e.device_type() == DeviceType.CUDA:
            if _device_op(e):
                ops.append(Interval(e.name(), start, end))
        elif e.name().startswith("bench."):
            span = Interval(e.name(), start, end)
            if e.name() == WINDOW:
                window = span
            else:
                spans.append(span)
    if window is None:
        raise RuntimeError("the trace holds no bench.window span")
    clipped = [Interval(o.name, max(o.start_ns, window.start_ns), min(o.end_ns, window.end_ns))
               for o in ops if o.end_ns > window.start_ns and o.start_ns < window.end_ns]
    return Trace(window, clipped, spans)


@contextlib.contextmanager
def profiled(enabled: bool) -> Iterator[Optional[object]]:
    """A ``torch.profiler`` session of host and device (or nothing)."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof


def span(name: str):
    """A harness span (``record_function``); cheap when nothing profiles."""
    from torch.profiler import record_function

    return record_function(name)
