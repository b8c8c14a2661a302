"""Seeded chaos harness for the streaming engine.

The port of ``repro.runtime.chaos`` (stdlib only, copied as is).  One seeded
``random.Random`` drives every injection, so a given ``(seed, call
sequence)`` replays exactly — the engine's overload and failure paths
(deadline expiry, KV-block preemption, load shedding, per-request fault
isolation) are exercised in CI with zero real networking, zero real sleeps,
and zero flaky randomness.

Injection points:

* **step faults** (``step_fault_rate``) — :meth:`before_step` raises a
  transient :class:`ChaosError` before a prefill/decode step, simulating a
  kernel-step exception (a CUDA launch failure, an OOM, a NaN guard).  The
  hardened engine retries the step one request at a time, so a transient
  fault costs a retry, never a request.
* **poisoned requests** (``poison_rids``) — any step containing a poisoned
  rid raises *deterministically*, simulating a request whose data reliably
  kills the kernel.  Isolation pins the blame: only the poisoned request
  retires with ``error`` status.
* **block-pool pressure** (``squeeze_rate``/``squeeze_hold``) — :meth:`tick`
  allocates pool blocks under sentinel rids and holds them for a bounded
  number of scheduler iterations, shrinking the free list under the live
  engine.  This forces the admission bound, :class:`KVPoolExhausted`
  handling, and priority preemption paths that a right-sized pool never
  reaches.
* **virtual delays** (``delay_rate``/``delay_s``) — :meth:`step_delay`
  returns extra *virtual* seconds to add to a step's measured wall time, so
  deadline expiry is reachable deterministically on the virtual clock
  (real steps on a smoke config are far faster than any realistic TTL).

Malformed requests and pathological arrival bursts are trace-level faults:
:func:`repro_torch.data.pipeline.adversarial_trace` layers them over the bursty
open-loop trace from the same kind of seeded RNG.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any, Iterable, List, Sequence, Tuple


class ChaosError(RuntimeError):
    """An injected kernel-step failure.

    ``rids`` names the requests the fault is pinned to (poisoned requests);
    empty for transient faults, which blame nobody and pass on retry.
    """

    def __init__(self, message: str, rids: Sequence[int] = ()) -> None:
        super().__init__(message)
        self.rids: Tuple[int, ...] = tuple(rids)


@dataclass
class ChaosStats:
    """What the injector actually did — asserted by tests and benchmarks."""

    steps_seen: int = 0
    transient_faults: int = 0
    poison_faults: int = 0
    blocks_squeezed: int = 0
    blocks_released: int = 0
    delays: int = 0
    delay_s: float = 0.0
    ticks: int = 0

    @property
    def faults(self) -> int:
        return self.transient_faults + self.poison_faults

    def as_metrics(self) -> dict:
        """Flat numeric snapshot for the metrics registry
        (:func:`repro_torch.obs.metrics.snapshot_stats` protocol)."""
        return {
            "steps_seen": self.steps_seen,
            "transient_faults": self.transient_faults,
            "poison_faults": self.poison_faults,
            "faults": self.faults,
            "blocks_squeezed": self.blocks_squeezed,
            "blocks_released": self.blocks_released,
            "delays": self.delays,
            "delay_s": self.delay_s,
            "ticks": self.ticks,
        }


class ChaosInjector:
    """Deterministic seeded fault injection around a StreamingEngine.

    The engine calls :meth:`tick` once per scheduler iteration (pool
    pressure evolves on iteration count, so a stalled engine still sees its
    stolen blocks come back), :meth:`before_step` immediately before each
    prefill/decode execution, and :meth:`step_delay` after each measured
    step.  All decisions come from one ``random.Random(seed)``.
    """

    # sentinel rids for squeezed blocks: disjoint from any real request rid
    _SQUEEZE_BASE = -1_000_000

    def __init__(
        self,
        seed: int = 0,
        step_fault_rate: float = 0.0,
        poison_rids: Iterable[int] = (),
        squeeze_rate: float = 0.0,
        squeeze_hold: int = 4,
        delay_rate: float = 0.0,
        delay_s: float = 0.02,
    ) -> None:
        self.step_fault_rate = float(step_fault_rate)
        self.poison_rids = frozenset(int(r) for r in poison_rids)
        self.squeeze_rate = float(squeeze_rate)
        self.squeeze_hold = int(squeeze_hold)
        self.delay_rate = float(delay_rate)
        self.delay_amount_s = float(delay_s)
        self._rng = random.Random(seed)
        self._seq = 0
        # (release_at_tick, sentinel_rid) for blocks currently held
        self._held: List[Tuple[int, int]] = []
        self.stats = ChaosStats()

    # -- engine hooks --------------------------------------------------------

    def before_step(self, kind: str, rids: Sequence[int]) -> None:
        """Maybe raise before a prefill/decode step.

        Poisoned rids raise deterministically (every time, so isolation can
        pin them); otherwise the seeded RNG draws one transient fault per
        step at ``step_fault_rate``.
        """
        self.stats.steps_seen += 1
        poisoned = sorted(self.poison_rids.intersection(int(r) for r in rids))
        if poisoned:
            self.stats.poison_faults += 1
            raise ChaosError(
                f"injected poison fault in {kind} step (rids {poisoned})",
                rids=poisoned,
            )
        if self.step_fault_rate and self._rng.random() < self.step_fault_rate:
            self.stats.transient_faults += 1
            raise ChaosError(f"injected transient fault in {kind} step")

    def step_delay(self) -> float:
        """Extra virtual seconds to charge the step that just ran."""
        if self.delay_rate and self._rng.random() < self.delay_rate:
            self.stats.delays += 1
            self.stats.delay_s += self.delay_amount_s
            return self.delay_amount_s
        return 0.0

    def tick(self, cache: Any) -> None:
        """Once per scheduler iteration: evolve block-pool pressure.

        Releases held blocks whose hold expired, then maybe squeezes a new
        one.  ``cache`` is the engine's :class:`PagedKVCache`; squeezed
        blocks go through its normal allocate/release bookkeeping under
        sentinel rids, so the engine's own invariants (free-list accounting,
        idempotent release) cover them too.
        """
        self.stats.ticks += 1
        still_held = []
        for release_at, rid in self._held:
            if self.stats.ticks >= release_at:
                cache.release(rid)
                self.stats.blocks_released += 1
            else:
                still_held.append((release_at, rid))
        self._held = still_held
        if (
            self.squeeze_rate
            and cache.free > 0
            and self._rng.random() < self.squeeze_rate
        ):
            self._seq += 1
            rid = self._SQUEEZE_BASE - self._seq
            cache.allocate(rid)
            self._held.append((self.stats.ticks + self.squeeze_hold, rid))
            self.stats.blocks_squeezed += 1

    def drain(self, cache: Any) -> None:
        """Release every still-held block (end of a serve run)."""
        for _, rid in self._held:
            cache.release(rid)
            self.stats.blocks_released += 1
        self._held = []

    @property
    def holding(self) -> int:
        return len(self._held)
