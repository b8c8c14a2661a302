"""Transports for the global tuning service.

The port's own copy of ``repro.fleet.transport`` (it holds no arrays).

The service protocol is one JSON request/response pair per operation, so a
transport is a single method: ``request(op, payload) -> response``.  Three
implementations:

* :class:`InProcessTransport` — direct calls into a live
  :class:`~repro_torch.fleet.service.TuningService` instance.  Zero networking;
  the substrate the fault-injection transport and the benchmarks wrap.
* :class:`HTTPTransport` — stdlib ``urllib`` against the service's
  ``http.server`` endpoint (no new dependencies).  Any socket-level
  failure, non-200 status, or timeout surfaces as :class:`TransportError`
  so the client's retry/degrade machinery treats real networks and
  injected faults identically.
* :class:`FaultInjectionTransport` — the deterministic test seam: wraps any
  inner transport and injects dropped requests, dropped responses,
  duplicated deliveries, reordered (held-then-replayed) deliveries, and a
  full partition, all driven by one seeded RNG.  Every push-style
  operation in the protocol is an idempotent lattice join, which is
  exactly why this menu of faults is survivable: a retry after a dropped
  *response* re-applies a join that already landed, a held duplicate
  replays it later, and neither changes the merged state.

Faults only apply to mutating operations (``MUTATING_OPS``); read-only
pulls fail only under partition.  That mirrors reality — a lost read is
just retried — and keeps the convergence property tests focused on the
write path, where duplication/reordering could corrupt a non-CRDT store.
"""
from __future__ import annotations

import json
import random
import urllib.error
import urllib.request
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

# Operations whose delivery the fault injector may drop/duplicate/reorder.
# All of them are idempotent joins (push/sync merge entries; demote is a
# flag strip that is a no-op when re-applied), so any delivery schedule
# converges.
MUTATING_OPS = ("push", "sync", "demote")


class TransportError(RuntimeError):
    """A request did not complete: timeout, refused, dropped, partitioned."""


class VirtualClock:
    """A monotonic clock + sleep that advances instantly (test seam).

    The service client takes ``sleep``/``now`` callables, so backoff tests
    assert exact retry *timing* without a single real sleep.
    """

    def __init__(self, start: float = 0.0) -> None:
        self._t = float(start)
        self.sleeps: List[float] = []

    def now(self) -> float:
        return self._t

    def sleep(self, seconds: float) -> None:
        self.sleeps.append(float(seconds))
        self._t += float(seconds)


class Transport:
    """One service operation in, one response out (or TransportError)."""

    def request(self, op: str, payload: Dict[str, Any]) -> Dict[str, Any]:
        raise NotImplementedError

    def close(self) -> None:  # pragma: no cover - nothing to release
        pass


class InProcessTransport(Transport):
    """Direct dispatch into a TuningService living in this process."""

    def __init__(self, service: Any) -> None:
        self.service = service

    def request(self, op: str, payload: Dict[str, Any]) -> Dict[str, Any]:
        return self.service.handle(op, payload)


class HTTPTransport(Transport):
    """The service's JSON-over-HTTP endpoint via stdlib urllib."""

    def __init__(self, url: str, timeout_s: float = 5.0) -> None:
        self.url = url.rstrip("/")
        self.timeout_s = float(timeout_s)

    def request(self, op: str, payload: Dict[str, Any]) -> Dict[str, Any]:
        body = json.dumps({"op": op, "payload": payload}, default=str).encode()
        req = urllib.request.Request(
            f"{self.url}/rpc", data=body,
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                if resp.status != 200:
                    raise TransportError(f"service returned {resp.status}")
                return json.loads(resp.read().decode())
        except TransportError:
            raise
        except (urllib.error.URLError, OSError, ValueError) as e:
            # URLError wraps socket timeouts and refused connections;
            # ValueError covers a half-written JSON body from a dying server
            raise TransportError(f"{op}: {e}") from e


@dataclass
class FaultStats:
    """What the injector actually did — asserted by tests and benchmarks."""

    requests: int = 0
    delivered: int = 0
    dropped_requests: int = 0
    dropped_responses: int = 0
    duplicated: int = 0
    reordered: int = 0
    replayed: int = 0
    partition_rejections: int = 0
    partitions: int = 0
    heals: int = 0

    @property
    def faults(self) -> int:
        return (self.dropped_requests + self.dropped_responses
                + self.duplicated + self.reordered
                + self.partition_rejections)


class FaultInjectionTransport(Transport):
    """Deterministic seeded fault injection around any inner transport.

    Per mutating request, in order, the seeded RNG may:

    * **reorder** (``reorder``): hold the request undelivered and raise —
      the client retries (a fresh delivery), and the held original is
      replayed *after* a later request, i.e. delivered out of order;
    * **drop the request** (``drop_request``): never delivered, raise;
    * **duplicate** (``duplicate``): delivered twice back to back;
    * **drop the response** (``drop_response``): delivered, but the caller
      sees a timeout — the retry double-applies the join.

    ``partition()`` fails every call (reads included) until ``heal()``,
    which also replays any held reordered requests.  All decisions come
    from one ``random.Random(seed)``, so a given (seed, call sequence) is
    exactly reproducible — the whole service stack is exercisable in CI
    with zero real networking and zero real time.
    """

    def __init__(
        self,
        inner: Transport,
        seed: int = 0,
        drop_request: float = 0.0,
        drop_response: float = 0.0,
        duplicate: float = 0.0,
        reorder: float = 0.0,
    ) -> None:
        self.inner = inner
        self.drop_request = drop_request
        self.drop_response = drop_response
        self.duplicate = duplicate
        self.reorder = reorder
        self._rng = random.Random(seed)
        self._held: List[Tuple[str, Dict[str, Any]]] = []
        self.partitioned = False
        self.stats = FaultStats()

    # -- fault control (the test's hand on the network) ----------------------

    def partition(self) -> None:
        if not self.partitioned:
            self.partitioned = True
            self.stats.partitions += 1

    def heal(self) -> None:
        """End the partition and replay held (reordered) requests."""
        if self.partitioned:
            self.partitioned = False
            self.stats.heals += 1
        self._replay_held()

    # -- Transport -----------------------------------------------------------

    def request(self, op: str, payload: Dict[str, Any]) -> Dict[str, Any]:
        self.stats.requests += 1
        if self.partitioned:
            self.stats.partition_rejections += 1
            raise TransportError(f"{op}: network partition")
        if op in MUTATING_OPS:
            if self._rng.random() < self.reorder:
                # held: a *later* request will carry it to the service
                self._held.append((op, json.loads(json.dumps(payload,
                                                             default=str))))
                self.stats.reordered += 1
                raise TransportError(f"{op}: request delayed (reordered)")
            if self._rng.random() < self.drop_request:
                self.stats.dropped_requests += 1
                raise TransportError(f"{op}: request lost")
        resp = self._deliver(op, payload)
        self._replay_held()
        if op in MUTATING_OPS:
            if self._rng.random() < self.duplicate:
                self._deliver(op, payload)
                self.stats.duplicated += 1
            if self._rng.random() < self.drop_response:
                self.stats.dropped_responses += 1
                raise TransportError(f"{op}: response lost")
        return resp

    # -- internals -----------------------------------------------------------

    def _deliver(self, op: str, payload: Dict[str, Any]) -> Dict[str, Any]:
        self.stats.delivered += 1
        return self.inner.request(op, payload)

    def _replay_held(self) -> None:
        while self._held:
            op, payload = self._held.pop(0)
            self.stats.replayed += 1
            self.inner.request(op, payload)
