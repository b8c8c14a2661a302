"""Observability for the port.

* :mod:`.trace` — nested spans, ring-buffer flight recorder, Perfetto export;
* :mod:`.metrics` — counter/gauge/histogram registry with a Prometheus text
  writer and ``as_metrics()`` stats adapters;
* :mod:`.explain` — TuningDB-backed decision audit reports.

Only the stdlib-pure pillars are re-exported: :mod:`.explain` imports
``repro_torch.core.db``, and core imports :mod:`.trace`, so consumers
import it lazily (``from repro_torch.obs import explain``).
"""
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    parse_prometheus,
    snapshot_stats,
)
from .trace import TickTimer, Tracer, current_tracer, set_tracer, use_tracer

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "parse_prometheus",
    "snapshot_stats",
    "TickTimer",
    "Tracer",
    "current_tracer",
    "set_tracer",
    "use_tracer",
]
