"""The training stream and serving traffic for the port (:mod:`.pipeline`)."""
from .pipeline import (
    SyntheticLMDataset,
    ServingRequest,
    adversarial_trace,
    bursty_open_loop_trace,
    mixed_traffic_trace,
    synthetic_requests,
)

__all__ = [
    "SyntheticLMDataset",
    "ServingRequest",
    "adversarial_trace",
    "bursty_open_loop_trace",
    "mixed_traffic_trace",
    "synthetic_requests",
]
