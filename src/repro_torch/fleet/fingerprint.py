"""Device fingerprinting — the fleet's BP dimension.

The port's copy of ``repro.fleet.fingerprint``.  The paper's premise is
that "computers have diversified architectures": ppOpen-AT re-runs its
search per machine because a winner tuned on one machine does not transfer
to another.  :class:`DeviceFingerprint` is a small frozen record of the
facts that decide whether a tuned winner transfers — backend, device kind,
device count, host core count, a power-of-two memory bucket and the DB
schema version — that flattens into BP entries (:meth:`bp_entries`) and
composes with any shape class via ``BasicParams.with_entries``.

The fields and their words are the JAX package's: ``backend`` is ``"gpu"``
on a CUDA device and ``"cpu"`` on the host, as ``jax.default_backend()``
names the same machines, and ``platform`` is the device's name
(``torch.cuda.get_device_name``) or ``"cpu"``.  So a TuningDB keyed by
either package merges with the other's.

Unlike JAX, whose default device is process-wide, one port process runs
CPU plain versions and CUDA kernels side by side.  So a call is keyed by
the device of its tensors: :func:`local_device` takes a ``torch.device``
and caches one fingerprint per device.

Recall semantics (``AutotunedOp(device_key=True)``): a *final* best is
recalled only on the exactly matching device; another device's final is
still reachable as a warm start through ``TuningDB.nearest_tuned``.
Memory is bucketed to a power of two GiB, so two hosts whose DIMMs differ
by a few hundred MB share results.
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Dict, Mapping

_PREFIX = "device_"


@dataclass(frozen=True)
class DeviceFingerprint:
    """Identity of one tuning target, as a composable BP dimension."""

    backend: str       # "gpu" on a CUDA device, "cpu" on the host
    platform: str      # device kind, e.g. "NVIDIA H100 80GB HBM3" or "cpu"
    device_count: int  # visible devices of that kind
    host_cores: int    # os.cpu_count() — the paper's max-thread dimension
    memory_gib: int    # pow2 bucket of host memory
    schema: int        # TuningDB schema version

    BP_KEYS = (
        f"{_PREFIX}backend",
        f"{_PREFIX}platform",
        f"{_PREFIX}count",
        f"{_PREFIX}cores",
        f"{_PREFIX}mem_gib",
        f"{_PREFIX}schema",
    )

    @classmethod
    def detect(cls, device: Any = None) -> "DeviceFingerprint":
        """Fingerprint ``device`` (a ``torch.device`` or its name; default
        the first CUDA device when there is one, else the host)."""
        import torch

        from ..core.db import SCHEMA_VERSION

        device = _as_device(device)
        if device.type == "cuda":
            backend = "gpu"
            platform = torch.cuda.get_device_name(device)
            count = torch.cuda.device_count()
        else:
            backend = platform = "cpu"
            count = 1
        return cls(
            backend=backend,
            platform=str(platform),
            device_count=int(count),
            host_cores=os.cpu_count() or 1,
            memory_gib=_pow2_bucket(_host_memory_gib()),
            schema=SCHEMA_VERSION,
        )

    def bp_entries(self) -> Dict[str, Any]:
        """Flat BP entries, so device identity composes orthogonally."""
        return {
            f"{_PREFIX}backend": self.backend,
            f"{_PREFIX}platform": self.platform,
            f"{_PREFIX}count": int(self.device_count),
            f"{_PREFIX}cores": int(self.host_cores),
            f"{_PREFIX}mem_gib": int(self.memory_gib),
            f"{_PREFIX}schema": int(self.schema),
        }

    @classmethod
    def from_bp_entries(cls, bp: Mapping[str, Any]) -> "DeviceFingerprint":
        return cls(
            backend=str(bp[f"{_PREFIX}backend"]),
            platform=str(bp[f"{_PREFIX}platform"]),
            device_count=int(bp[f"{_PREFIX}count"]),
            host_cores=int(bp[f"{_PREFIX}cores"]),
            memory_gib=int(bp[f"{_PREFIX}mem_gib"]),
            schema=int(bp[f"{_PREFIX}schema"]),
        )

    @property
    def label(self) -> str:
        return (
            f"{self.backend}/{self.platform.replace(' ', '_')}"
            f"x{self.device_count}/c{self.host_cores}/m{self.memory_gib}g"
            f"/v{self.schema}"
        )

    def arch_spec(self):
        """The emit layer's model of this device: the card's
        :class:`~repro_torch.core.arch.ArchSpec` (the H100's on an H100) on
        a GPU fingerprint, the CPU host's otherwise."""
        from ..core.arch import CPU_HOST, local_arch

        return local_arch() if self.backend == "gpu" else CPU_HOST


def _as_device(device: Any):
    import torch

    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _host_memory_gib() -> float:
    """Total host memory in GiB; 1.0 when undetectable (still deterministic)."""
    try:
        page = os.sysconf("SC_PAGE_SIZE")
        pages = os.sysconf("SC_PHYS_PAGES")
        if page > 0 and pages > 0:
            return (page * pages) / 2**30
    except (ValueError, OSError, AttributeError):
        pass
    return 1.0


def _pow2_bucket(gib: float) -> int:
    """Round up to the next power-of-two GiB (minimum 1)."""
    n = 1
    while n < gib:
        n *= 2
    return n


_LOCAL: Dict[str, DeviceFingerprint] = {}
_LOCAL_LOCK = threading.Lock()


def local_device(device: Any = None) -> DeviceFingerprint:
    """The fingerprint of ``device`` (default: the first CUDA device when
    there is one, else the host), detected once per device and process.

    Detection touches the CUDA runtime, so it is lazy: importing
    :mod:`repro_torch.fleet` stays free.
    """
    key = str(_as_device(device))
    with _LOCAL_LOCK:
        fp = _LOCAL.get(key)
        if fp is None:
            fp = _LOCAL[key] = DeviceFingerprint.detect(key)
    return fp


def device_bp_entries(device: Any = None) -> Dict[str, Any]:
    """BP entries of the fingerprint of ``device`` (a ``torch.device`` or
    its name; default as in :func:`local_device`).

    The one-liner shape-class extension:
    ``bp.with_entries(**device_bp_entries(x.device))``.
    """
    return local_device(device).bp_entries()
