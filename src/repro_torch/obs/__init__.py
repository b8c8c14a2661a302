"""Observability for the port: structured tracing (:mod:`.trace`).

The metrics registry and the TuningDB ``explain`` report wait for a later
slice.
"""
from .trace import TickTimer, Tracer, current_tracer, set_tracer, use_tracer

__all__ = ["TickTimer", "Tracer", "current_tracer", "set_tracer", "use_tracer"]
