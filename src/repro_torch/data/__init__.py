"""Serving traffic for the port (:mod:`.pipeline`)."""
from .pipeline import (
    ServingRequest,
    adversarial_trace,
    bursty_open_loop_trace,
    mixed_traffic_trace,
    synthetic_requests,
)

__all__ = [
    "ServingRequest",
    "adversarial_trace",
    "bursty_open_loop_trace",
    "mixed_traffic_trace",
    "synthetic_requests",
]
