"""Metrics registry: counters / gauges / histograms with label sets, a
Prometheus text-exposition writer, and adapters that pull every ad-hoc
stats object (``StreamStats``, ``ChaosStats``, ``ClientStats``,
``WorkerReport``, ``TuningService.stats``) through one pipe.

Stdlib-only, no repro imports (see trace.py for the layering rule).

The collection model is pull-based: :meth:`MetricsRegistry.register_stats`
stores a *collector* closure that re-snapshots its stats object each time
the registry is rendered, so ``GET /metrics`` on a live service and
``--metrics-out`` at the end of a run both observe current values.  Stats
objects opt in by exposing ``as_metrics() -> dict[str, number]``; plain
dicts of numbers work too.
"""
from __future__ import annotations

import re
import threading
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Tuple

__all__ = [
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "parse_prometheus",
    "snapshot_stats",
]

DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0,
)

_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_NAME_FIX = re.compile(r"[^a-zA-Z0-9_:]")
_LINE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+([+-]?(?:\d+\.?\d*(?:[eE][+-]?\d+)?|Inf|NaN))$"
)


def sanitize_name(name: str) -> str:
    name = _NAME_FIX.sub("_", str(name))
    if not name or not _NAME_OK.match(name):
        name = "_" + name
    return name


def _escape_label(value: Any) -> str:
    return (
        str(value).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _fmt(value: float) -> str:
    """Deterministic sample formatting: integers render bare, floats via
    repr (shortest round-trip form)."""
    f = float(value)
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def snapshot_stats(stats: Any) -> Dict[str, float]:
    """Normalize a stats object into a flat name->number snapshot.

    Prefers the ``as_metrics()`` protocol; falls back to a numeric-valued
    mapping (``TuningService.stats`` is a plain dict of counters)."""
    if hasattr(stats, "as_metrics"):
        raw = stats.as_metrics()
    elif isinstance(stats, Mapping):
        raw = stats
    else:  # last resort: public numeric attributes
        raw = {
            k: v for k, v in vars(stats).items()
            if not k.startswith("_") and isinstance(v, (int, float))
        }
    out: Dict[str, float] = {}
    for k, v in raw.items():
        if isinstance(v, bool):
            out[str(k)] = 1.0 if v else 0.0
        elif isinstance(v, (int, float)):
            out[str(k)] = float(v)
    return out


class _Labeled:
    """Shared label-keyed storage for one metric family."""

    def __init__(self, name: str, help: str):
        self.name = sanitize_name(name)
        self.help = help
        self._values: Dict[Tuple[Tuple[str, str], ...], Any] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _key(labels: Mapping[str, Any]) -> Tuple[Tuple[str, str], ...]:
        return tuple(sorted((str(k), str(v)) for k, v in labels.items()))

    def label_sets(self) -> List[Tuple[Tuple[str, str], ...]]:
        with self._lock:
            return sorted(self._values)


class Counter(_Labeled):
    kind = "counter"

    def inc(self, value: float = 1.0, **labels: Any) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        k = self._key(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + float(value)

    def value(self, **labels: Any) -> float:
        with self._lock:
            return float(self._values.get(self._key(labels), 0.0))

    def samples(self) -> Iterable[Tuple[str, Tuple[Tuple[str, str], ...], float]]:
        with self._lock:
            items = sorted(self._values.items())
        for k, v in items:
            yield self.name, k, v


class Gauge(_Labeled):
    kind = "gauge"

    def set(self, value: float, **labels: Any) -> None:
        with self._lock:
            self._values[self._key(labels)] = float(value)

    def inc(self, value: float = 1.0, **labels: Any) -> None:
        k = self._key(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + float(value)

    def value(self, **labels: Any) -> float:
        with self._lock:
            return float(self._values.get(self._key(labels), 0.0))

    samples = Counter.samples


class Histogram(_Labeled):
    kind = "histogram"

    def __init__(self, name: str, help: str, buckets: Optional[Iterable[float]] = None):
        super().__init__(name, help)
        self.buckets = tuple(sorted(float(b) for b in (buckets or DEFAULT_BUCKETS)))

    def observe(self, value: float, **labels: Any) -> None:
        v = float(value)
        k = self._key(labels)
        with self._lock:
            st = self._values.setdefault(
                k, {"counts": [0] * len(self.buckets), "sum": 0.0, "count": 0}
            )
            st["sum"] += v
            st["count"] += 1
            for i, b in enumerate(self.buckets):
                if v <= b:
                    # per-bucket counts; samples() accumulates into the
                    # cumulative ``le`` form Prometheus expects
                    st["counts"][i] += 1
                    break

    def samples(self) -> Iterable[Tuple[str, Tuple[Tuple[str, str], ...], float]]:
        with self._lock:
            items = sorted(
                (k, {"counts": list(s["counts"]), "sum": s["sum"], "count": s["count"]})
                for k, s in self._values.items()
            )
        for k, st in items:
            cum = 0
            for b, n in zip(self.buckets, st["counts"]):
                cum += n
                yield f"{self.name}_bucket", k + (("le", _fmt(b)),), float(cum)
            yield f"{self.name}_bucket", k + (("le", "+Inf"),), float(st["count"])
            yield f"{self.name}_sum", k, float(st["sum"])
            yield f"{self.name}_count", k, float(st["count"])


class MetricsRegistry:
    """Family registry + pull-time collectors + exposition writers."""

    def __init__(self) -> None:
        self._metrics: Dict[str, _Labeled] = {}
        self._collectors: List[Callable[["MetricsRegistry"], None]] = []
        self._lock = threading.Lock()

    def _family(self, cls: type, name: str, help: str, **kw: Any) -> Any:
        name = sanitize_name(name)
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, **kw)
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}"
                )
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._family(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._family(Gauge, name, help)

    def histogram(
        self, name: str, help: str = "", buckets: Optional[Iterable[float]] = None
    ) -> Histogram:
        return self._family(Histogram, name, help, buckets=buckets)

    def register_collector(self, fn: Callable[["MetricsRegistry"], None]) -> None:
        """``fn(registry)`` runs at every exposition; it refreshes gauges."""
        self._collectors.append(fn)

    def register_stats(
        self,
        prefix: str,
        stats: Any,
        help: str = "",
        **labels: Any,
    ) -> None:
        """Adapt one ad-hoc stats object (``as_metrics()`` protocol or a
        numeric mapping) into per-field gauges ``<prefix>_<field>``,
        re-snapshotted at every exposition so live values flow through."""

        def _collect(reg: "MetricsRegistry") -> None:
            for field, value in snapshot_stats(stats).items():
                reg.gauge(f"{prefix}_{field}", help=help).set(value, **labels)

        self.register_collector(_collect)

    # -- exposition --------------------------------------------------------

    def collect(self) -> List[_Labeled]:
        for fn in list(self._collectors):
            fn(self)
        with self._lock:
            return [self._metrics[n] for n in sorted(self._metrics)]

    def prometheus_text(self) -> str:
        """Prometheus text exposition format 0.0.4, deterministically
        ordered (families by name, samples by label set)."""
        lines: List[str] = []
        for m in self.collect():
            lines.append(f"# HELP {m.name} {m.help or m.name}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for sample_name, label_key, value in m.samples():
                if label_key:
                    body = ",".join(
                        f'{sanitize_name(k)}="{_escape_label(v)}"'
                        for k, v in label_key
                    )
                    lines.append(f"{sample_name}{{{body}}} {_fmt(value)}")
                else:
                    lines.append(f"{sample_name} {_fmt(value)}")
        return "\n".join(lines) + "\n"

    def report(self, title: Optional[str] = None) -> str:
        """Human-oriented plain report — the unified replacement for the
        per-class ad-hoc stat printing in the launch CLIs."""
        lines: List[str] = []
        if title:
            lines.append(f"-- {title} --")
        for m in self.collect():
            for sample_name, label_key, value in m.samples():
                if sample_name.endswith(("_bucket", "_sum")):
                    continue  # histogram detail stays in /metrics
                label = (
                    "{" + ",".join(f"{k}={v}" for k, v in label_key) + "}"
                    if label_key else ""
                )
                lines.append(f"  {sample_name}{label} = {_fmt(value)}")
        return "\n".join(lines)

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.prometheus_text())


def parse_prometheus(text: str) -> Dict[str, List[Tuple[Dict[str, str], float]]]:
    """Minimal strict parser for the text we emit (used by the observe CLI
    and the CI smoke job to assert ``GET /metrics`` output parses).
    Raises ``ValueError`` on any malformed line."""
    out: Dict[str, List[Tuple[Dict[str, str], float]]] = {}
    for ln, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            if line.startswith("#") and not line.startswith(("# HELP ", "# TYPE ")):
                raise ValueError(f"line {ln}: malformed comment {raw!r}")
            continue
        m = _LINE.match(line)
        if not m:
            raise ValueError(f"line {ln}: malformed sample {raw!r}")
        name, labels_raw, value = m.group(1), m.group(2), m.group(3)
        labels: Dict[str, str] = {}
        if labels_raw:
            body = labels_raw[1:-1].strip()
            if body:
                for part in re.findall(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"', body):
                    labels[part[0]] = part[1]
                if len(labels) != body.count("="):
                    raise ValueError(f"line {ln}: malformed labels {raw!r}")
        out.setdefault(name, []).append((labels, float(value)))
    if not out:
        raise ValueError("no samples found")
    return out
