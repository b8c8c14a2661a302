"""repro_torch.fleet — the fleet tuning control plane, on the card.

The port of ``repro.fleet``, with the same exports, on the port's core:

* :class:`~repro_torch.fleet.fingerprint.DeviceFingerprint` — device
  identity as a composable BP dimension, keyed by the device of a call's
  tensors, so TuningDBs from heterogeneous hosts merge without clobbering
  and finals only transfer between matching targets;
* :class:`~repro_torch.fleet.coordinator.FleetCoordinator` /
  :class:`~repro_torch.fleet.coordinator.FleetSearch` — deterministic
  sharded search across N workers (threads, which time one at a time on a
  card, or ``multiprocessing`` spawn for picklable costs) with a
  ``TuningDB.merge`` barrier that reproduces the single-process winner;
* :class:`~repro_torch.fleet.drift.DriftMonitor` — EWMA drift watch over
  the dispatch fast path's run-time trickle (CUDA-event times on a card):
  demote a drifted final, re-tune off the hot path, canary the challenger,
  promote or roll back — every transition persisted in the DB's event log;
* :class:`~repro_torch.fleet.service.TuningService` /
  :class:`~repro_torch.fleet.service.ServiceClient` /
  :class:`~repro_torch.fleet.service.AntiEntropySync` — the global tuning
  service: hosts push scratch DBs and pull device-matched finals over any
  :class:`~repro_torch.fleet.transport.Transport` (in-process, stdlib HTTP,
  or the deterministic
  :class:`~repro_torch.fleet.transport.FaultInjectionTransport`).
"""
from .coordinator import (
    BACKENDS,
    SHARD_POLICIES,
    FleetCoordinator,
    FleetResult,
    FleetSearch,
    WorkerReport,
)
from .drift import DriftMonitor
from .fingerprint import DeviceFingerprint, device_bp_entries, local_device
from .service import (
    AntiEntropySync,
    ClientStats,
    ServiceClient,
    ServiceUnavailable,
    TuningService,
    serve_http,
)
from .transport import (
    FaultInjectionTransport,
    FaultStats,
    HTTPTransport,
    InProcessTransport,
    Transport,
    TransportError,
    VirtualClock,
)

__all__ = [
    "BACKENDS",
    "SHARD_POLICIES",
    "AntiEntropySync",
    "ClientStats",
    "DeviceFingerprint",
    "DriftMonitor",
    "FaultInjectionTransport",
    "FaultStats",
    "FleetCoordinator",
    "FleetResult",
    "FleetSearch",
    "HTTPTransport",
    "InProcessTransport",
    "ServiceClient",
    "ServiceUnavailable",
    "Transport",
    "TransportError",
    "TuningService",
    "VirtualClock",
    "WorkerReport",
    "device_bp_entries",
    "local_device",
    "serve_http",
]
