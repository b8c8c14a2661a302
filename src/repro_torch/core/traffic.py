"""Serving traffic classes — the request-shape BP dimension.

The paper switches the tuned implementation *and* parallelism degree per
computational kernel at run time.  At serving scale the analogue of "which
kernel is running" is **which traffic is arriving**: a prefill over a long
prompt and a single-token decode step are different computations with
different tuned optima, and so are a batch of 2 and a batch of 32.  A
:class:`TrafficClass` buckets a concrete serve call into

    (phase, batch bucket, sequence bucket)

where phase is ``prefill`` or ``decode`` and the numeric dimensions round up
to the next power of two, so the unbounded space of request shapes collapses
into a small, enumerable set of classes.  Each class is one more BP
dimension (docs/design.md §3): it extends the kernel's shape-class
``BasicParams`` and therefore keys its own TuningDB entry, its own tuned
winner, and its own precompiled candidate set.

Classes are deliberately *coarse*: a class must be stable enough that tuning
it once in the background (``repro_torch.runtime.background_tuner``) pays off for
every later request that lands in it — see docs/serving.md.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

# "stream" is the scheduler's own phase: the continuous-batching engine
# (repro_torch.runtime.engine) classifies *queue states* rather than single calls —
# batch bucket = waiting requests, seq bucket = mean prompt length.
PHASES = ("prefill", "decode", "stream")


def bucket_pow2(n: int, floor: int = 1) -> int:
    """Round ``n`` up to the next power of two (at least ``floor``)."""
    if n < 1:
        raise ValueError(f"bucket_pow2 needs n >= 1, got {n}")
    b = max(1, int(floor))
    while b < n:
        b <<= 1
    return b


@dataclass(frozen=True)
class TrafficClass:
    """One serving traffic class: phase × batch bucket × sequence bucket."""

    phase: str
    batch_bucket: int
    seq_bucket: int

    # the BP-entry names bp_entries() emits — the single source of truth the
    # TuningDB traffic scan (db.traffic_classes) keys on
    BP_KEYS = ("phase", "batch_bucket", "seq_bucket")

    def __post_init__(self) -> None:
        if self.phase not in PHASES:
            raise ValueError(f"phase {self.phase!r} not in {PHASES}")

    @classmethod
    def of(cls, phase: str, batch: int, seq_len: int) -> "TrafficClass":
        """Bucket a concrete (phase, batch, seq_len) call into its class."""
        return cls(phase, bucket_pow2(int(batch)), bucket_pow2(int(seq_len)))

    @property
    def label(self) -> str:
        return f"{self.phase}/b{self.batch_bucket}/s{self.seq_bucket}"

    def bp_entries(self) -> Dict[str, Any]:
        """The BP entries this class contributes to a kernel's shape class.

        These names (:attr:`BP_KEYS`) are what
        :meth:`repro_torch.core.db.TuningDB.traffic_classes` scans for, making
        traffic a queryable DB dimension.
        """
        return {k: getattr(self, k) for k in self.BP_KEYS}

    @classmethod
    def from_bp_entries(cls, entries: Dict[str, Any]) -> "TrafficClass":
        return cls(
            str(entries["phase"]),
            int(entries["batch_bucket"]),
            int(entries["seq_bucket"]),
        )
