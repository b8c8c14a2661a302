"""The global tuning service.

The port's own copy of ``repro.fleet.service`` (it holds no arrays), on the
port's TuningDB and metrics.  Because :meth:`TuningDB.merge` is a commutative,
associative, idempotent lattice join, the TuningDB is a state-based CRDT —
eventually-consistent *remote* replication is free by construction.  This
module is the small amount of plumbing that cashes that in:

* :class:`TuningService` — a long-lived process holding the fleet's merged
  DB.  Hosts **push** scratch entries (a join), **pull** device-matched
  finals (exact :class:`~repro_torch.fleet.fingerprint.DeviceFingerprint` hit,
  falling back to the ``nearest_tuned`` nearest-device entry as a warm
  start), and **sync** (push + full pull back — one anti-entropy round).
  The service persists its DB to a path, so a restart resumes mid-fleet.
* :class:`ServiceClient` — the robustness layer every host talks through:
  per-request timeouts live in the transport, the client adds bounded
  exponential backoff with seeded jitter, idempotent retries (safe
  *because* push is a join), and graceful degradation — after retries are
  exhausted the client marks itself unavailable and ``try_*`` calls
  return ``None``/``False`` instead of raising, so tuning continues
  local-only; any later success flips it back to available.
* :class:`AntiEntropySync` — the host-side reconciliation loop: each round
  pushes the local DB, merges the service's state back, and applies the
  service's pending **re-tune requests** (fleet-wide drift propagation)
  by demoting locally and, when a :class:`~repro_torch.fleet.drift.DriftMonitor`
  is attached, scheduling the demote → re-tune → canary lifecycle on the
  matching live op state.
* :func:`serve_http` — the service on a stdlib ``http.server`` endpoint
  (one POST /rpc route speaking ``{"op", "payload"}`` JSON); no new deps.

Demotion is the one operation that is *not* a plain join: ``merge`` must
stay commutative, so a final best always beats a demoted copy of itself —
which would let host A's stale final resurrect a winner host B just
demoted (the lost-demotion race).  The service therefore
reconciles demotions causally, outside the join: a pushed ``demoted``
marker matching the service's live final (same point, same cost) demotes
the service copy and registers a **re-tune request**; after every
subsequent merge the service re-demotes any final that is byte-identical
to the demoted record (a stale re-promotion) and clears the request the
moment a *different* final lands (the re-tune's verdict — a new winner, or
the incumbent re-finalized at its freshly observed cost).  Both host's
markers survive: the demotion holds service-side until exactly one new
completed search supersedes it.
"""
from __future__ import annotations

import json
import random
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..core.db import TuningDB
from ..core.params import BasicParams
from ..obs.trace import current_tracer

from .transport import Transport, TransportError

PROTOCOL_VERSION = 1


class ServiceUnavailable(TransportError):
    """Every retry failed; the caller should degrade to local-only tuning."""


# ---------------------------------------------------------------------------
# The service
# ---------------------------------------------------------------------------


class TuningService:
    """The fleet's merged TuningDB behind a tiny op-dispatch protocol.

    ``path`` (optional) binds the DB to disk: every mutating op flushes, so
    a restarted service (``TuningService(path=...)`` again) resumes with
    everything any host ever pushed — the ppOpen-AT "results survive the
    run" discipline at fleet scope.
    """

    def __init__(self, path: Optional[str] = None, db: Optional[TuningDB] = None) -> None:
        self.db = db if db is not None else TuningDB(path)
        self._lock = threading.Lock()
        # fp -> the exact best record that was demoted; pending until a
        # *different* final lands for that fingerprint (see module docs)
        self._retune: Dict[str, Dict[str, Any]] = {}
        # fp -> {"demoted": record, "final": winner}: a satisfied request
        # keeps guarding.  The join resolves finals by lower cost, so a
        # stale final (recorded at the pre-drift cost) would beat the
        # re-tune's verdict (recorded at the honest, higher observed cost)
        # in every later merge; the guard restores the verdict whenever a
        # byte-identical copy of the demoted record resurfaces as final.
        self._superseded: Dict[str, Dict[str, Any]] = {}
        self.stats: Dict[str, int] = {
            "push": 0, "pull": 0, "sync": 0, "demote": 0, "health": 0,
            "entries_received": 0, "demotions_reconciled": 0,
        }

    # -- transport entry point ------------------------------------------------

    def handle(self, op: str, payload: Dict[str, Any]) -> Dict[str, Any]:
        """One protocol operation — the single seam every transport calls."""
        tr = current_tracer()
        if tr is None:
            return self._handle(op, payload)
        with tr.span("service.handle", cat="fleet", op=op) as attrs:
            resp = self._handle(op, payload)
            attrs["ok"] = bool(resp.get("ok", True))
            return resp

    def _handle(self, op: str, payload: Dict[str, Any]) -> Dict[str, Any]:
        payload = payload or {}
        if op == "health":
            self.stats["health"] += 1
            return {"ok": True, "protocol": PROTOCOL_VERSION,
                    "entries": len(self.db.fingerprints()),
                    "retune_pending": len(self._retune)}
        if op == "push":
            return self.push(payload.get("entries") or {})
        if op == "pull":
            return self.pull(payload["bp"],
                             match=tuple(payload.get("match") or ("kernel",)))
        if op == "sync":
            return self.sync(payload.get("entries") or {})
        if op == "demote":
            return self.demote(payload["bp"])
        raise ValueError(f"unknown service op {op!r}")

    # -- operations -----------------------------------------------------------

    def push(self, entries: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
        """Join pushed entries into the service DB (idempotent, retry-safe).

        Demoted markers in the push are reconciled causally before and
        after the join — see the module docstring for why this cannot live
        inside ``merge`` itself.
        """
        with self._lock:
            self.stats["push"] += 1
            return self._join_locked(entries)

    def _join_locked(self, entries: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
        self.stats["entries_received"] += len(entries)
        self._register_demotions(entries)
        self.db.merge(entries)
        self._reapply_demotions()
        self._persist()
        return {"ok": True, "merged": len(entries),
                "entries": len(self.db.fingerprints())}

    def pull(self, bp_entries: Dict[str, Any],
             match: Tuple[str, ...] = ("kernel",)) -> Dict[str, Any]:
        """Device-matched final for ``bp``, else the nearest tuned entry.

        ``found`` is ``"final"`` (exact fingerprint, completed search — the
        caller may adopt it with zero evaluations), ``"nearest"`` (a
        different shape class / device — a warm-start seed, never adopted
        verbatim), or ``None``.  Either way the full DB entry rides along,
        so the caller just merges it and the existing warm-start machinery
        (``TuningDB.nearest_tuned`` + ``project_point``) does the rest.
        """
        bp = BasicParams.make(**bp_entries)
        with self._lock:
            self.stats["pull"] += 1
            fp = bp.fingerprint()
            if self.db.tuned_point(bp) is not None:
                return {"found": "final", "fingerprint": fp,
                        "entry": self.db.export_entries([fp])[fp]}
            near = self.db.nearest_tuned(bp, match=match)
            if near is not None:
                nfp = near["fingerprint"]
                return {"found": "nearest", "fingerprint": nfp,
                        "distance": near["distance"],
                        "entry": self.db.export_entries([nfp])[nfp]}
            return {"found": None}

    def sync(self, entries: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
        """One anti-entropy round: join theirs, return everything + retunes."""
        with self._lock:
            self.stats["sync"] += 1
            resp = self._join_locked(entries)
            return {"ok": True, "entries": self.db.export_entries(),
                    "retune": {fp: dict(rec) for fp, rec in self._retune.items()},
                    "total": resp["entries"]}

    def demote(self, bp_entries: Dict[str, Any]) -> Dict[str, Any]:
        """Explicit fleet-wide demotion (a host's DriftMonitor tripped)."""
        bp = BasicParams.make(**bp_entries)
        with self._lock:
            self.stats["demote"] += 1
            fp = bp.fingerprint()
            record = self._best_record(fp)
            demoted = self.db.demote_fingerprint(fp)
            if demoted and record is not None:
                self._retune[fp] = {"point": record["point"],
                                    "cost": record["cost"]}
            self._persist()
            return {"ok": True, "demoted": demoted,
                    "pending": fp in self._retune}

    def retune_pending(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {fp: dict(rec) for fp, rec in self._retune.items()}

    # -- demotion reconciliation (the non-join part) --------------------------

    def _best_record(self, fp: str) -> Optional[Dict[str, Any]]:
        entry = self.db._data.get(fp)
        best = entry.get("best") if entry else None
        return dict(best) if best else None

    def _register_demotions(self, entries: Dict[str, Dict[str, Any]]) -> None:
        """A pushed ``demoted`` marker becomes a pending re-tune request.

        Arrival order must not matter (the lost-demotion race): whether the
        stale final is already here (demote it now), arrives in this very
        push (the join resolves final-over-demoted, then
        :meth:`_reapply_demotions` knocks it back down), or arrives in a
        *later* push (the pending request catches it), the demotion holds.
        The one case that does NOT register is a service-side final that
        already differs from the demoted record — a completed re-tune
        landed first, so the demotion is stale news.
        """
        for fp, theirs in entries.items():
            their_best = (theirs or {}).get("best") or {}
            if not their_best.get("demoted"):
                continue
            record = {"point": their_best.get("point"),
                      "cost": their_best.get("cost")}
            ours = self._best_record(fp)
            if ours is not None and ours.get("final"):
                if (ours.get("point") == record["point"]
                        and ours.get("cost") == record["cost"]):
                    self.db.demote_fingerprint(fp)
                    self._retune[fp] = record
                    self.stats["demotions_reconciled"] += 1
                # else: a different final already superseded the demotion
            else:
                self._retune[fp] = record
                self.stats["demotions_reconciled"] += 1

    def _reapply_demotions(self) -> None:
        """After a join: stale re-promotions fall, satisfied requests clear.

        A pending request holds the exact record that was demoted.  If the
        merge resurrected a final byte-identical to it (host A's stale copy
        of the very same claim), demote again; if a *different* final landed
        (a completed re-tune — new point, or the same point re-finalized at
        a freshly observed cost), the request is satisfied and becomes a
        *guard*: any later resurrection of the demoted record is overwritten
        with the re-tune's verdict (the join alone would pick the stale
        record — it carries the lower, pre-drift cost).
        """
        for fp, guard in self._superseded.items():
            best = self._best_record(fp)
            if (best is not None and best.get("final")
                    and any(best.get("point") == rec["point"]
                            and best.get("cost") == rec["cost"]
                            for rec in guard["demoted"])):
                entry = self.db._data.get(fp)
                if entry is not None:
                    entry["best"] = json.loads(
                        json.dumps(guard["final"], default=str)
                    )
                    self.stats["demotions_reconciled"] += 1
        for fp in list(self._retune):
            pending = self._retune[fp]
            best = self._best_record(fp)
            if best is None or not best.get("final"):
                continue  # still demoted; request stays pending
            if (best.get("point") == pending["point"]
                    and best.get("cost") == pending["cost"]):
                self.db.demote_fingerprint(fp)
                self.stats["demotions_reconciled"] += 1
            else:
                guard = self._superseded.setdefault(
                    fp, {"demoted": [], "final": None}
                )
                guard["demoted"].append(dict(pending))
                guard["final"] = dict(best)
                del self._retune[fp]

    def _persist(self) -> None:
        if self.db.path:
            self.db.save()


# ---------------------------------------------------------------------------
# The client (robustness layer)
# ---------------------------------------------------------------------------


@dataclass
class ClientStats:
    attempts: int = 0
    retries: int = 0
    failures: int = 0        # calls that exhausted every retry
    reconnects: int = 0      # degraded -> available transitions
    pushed_entries: int = 0
    pulled_finals: int = 0
    pulled_seeds: int = 0
    syncs: int = 0
    retunes_received: int = 0

    def as_metrics(self) -> Dict[str, int]:
        """Flat numeric snapshot for the metrics registry
        (:func:`repro_torch.obs.metrics.snapshot_stats` protocol)."""
        return {
            "attempts": self.attempts,
            "retries": self.retries,
            "failures": self.failures,
            "reconnects": self.reconnects,
            "pushed_entries": self.pushed_entries,
            "pulled_finals": self.pulled_finals,
            "pulled_seeds": self.pulled_seeds,
            "syncs": self.syncs,
            "retunes_received": self.retunes_received,
        }


class ServiceClient:
    """A host's handle on the tuning service, with the failure policy built in.

    Retries are safe by construction — every mutating op is an idempotent
    join — so the client retries each call up to ``retries`` times with
    bounded exponential backoff (``backoff_base * 2**attempt``, capped at
    ``backoff_cap``) and seeded jitter (a uniform 0.5–1.5× factor, so a
    fleet of hosts losing the same service does not retry in lockstep).
    ``sleep``/``now`` are injectable — tests drive the whole schedule on a
    :class:`~repro_torch.fleet.transport.VirtualClock` with zero real waiting.

    When a call exhausts its retries the client flips to unavailable
    (:attr:`available`) and raises :class:`ServiceUnavailable`; the
    ``try_*`` variants catch that and return ``None``/``False`` so callers
    degrade to local-only tuning without scattering try/except.  While
    unavailable, ``try_*`` calls short-circuit with a *single* probe
    attempt instead of a full retry ladder — the hot loop must not stall
    on a dead service — and any success reconnects.
    """

    def __init__(
        self,
        transport: Transport,
        retries: int = 4,
        backoff_base: float = 0.05,
        backoff_cap: float = 2.0,
        jitter_seed: int = 0,
        sleep: Callable[[float], None] = time.sleep,
        now: Callable[[], float] = time.monotonic,
    ) -> None:
        if retries < 0:
            raise ValueError(f"retries must be >= 0, got {retries}")
        self.transport = transport
        self.retries = int(retries)
        self.backoff_base = float(backoff_base)
        self.backoff_cap = float(backoff_cap)
        self._rng = random.Random(jitter_seed)
        self._sleep = sleep
        self._now = now
        self.available = True
        self.stats = ClientStats()

    # -- core call machinery ---------------------------------------------------

    def backoff_s(self, attempt: int) -> float:
        """The bounded, jittered delay before retry ``attempt`` (0-based)."""
        base = min(self.backoff_cap, self.backoff_base * (2 ** attempt))
        return base * (0.5 + self._rng.random())

    def _call(self, op: str, payload: Dict[str, Any],
              retries: Optional[int] = None) -> Dict[str, Any]:
        tr = current_tracer()
        if tr is None:
            return self._call_exec(op, payload, retries)
        attempts_before = self.stats.attempts
        with tr.span("service.call", cat="fleet", op=op) as attrs:
            try:
                resp = self._call_exec(op, payload, retries)
            except ServiceUnavailable:
                attrs["attempts"] = self.stats.attempts - attempts_before
                attrs["outcome"] = "unavailable"
                raise
            attrs["attempts"] = self.stats.attempts - attempts_before
            attrs["outcome"] = "ok"
            return resp

    def _call_exec(self, op: str, payload: Dict[str, Any],
                   retries: Optional[int] = None) -> Dict[str, Any]:
        retries = self.retries if retries is None else retries
        last: Optional[BaseException] = None
        for attempt in range(retries + 1):
            self.stats.attempts += 1
            try:
                resp = self.transport.request(op, payload)
            except TransportError as e:
                last = e
                if attempt < retries:
                    self.stats.retries += 1
                    self._sleep(self.backoff_s(attempt))
                continue
            if not self.available:
                self.available = True
                self.stats.reconnects += 1
            return resp
        self.available = False
        self.stats.failures += 1
        raise ServiceUnavailable(f"{op}: {last}") from last

    def _degraded_retries(self) -> Optional[int]:
        """Single-probe mode while unavailable (reconnects on success)."""
        return 0 if not self.available else None

    # -- protocol --------------------------------------------------------------

    def health(self) -> Dict[str, Any]:
        return self._call("health", {})

    def push(self, db: TuningDB, fingerprints: Optional[list] = None) -> Dict[str, Any]:
        entries = db.export_entries(fingerprints)
        resp = self._call("push", {"entries": entries},
                          retries=self._degraded_retries())
        self.stats.pushed_entries += len(entries)
        return resp

    def pull(self, bp: BasicParams,
             match: Tuple[str, ...] = ("kernel",)) -> Dict[str, Any]:
        resp = self._call("pull", {"bp": bp.asdict(), "match": list(match)},
                          retries=self._degraded_retries())
        if resp.get("found") == "final":
            self.stats.pulled_finals += 1
        elif resp.get("found") == "nearest":
            self.stats.pulled_seeds += 1
        return resp

    def sync(self, db: TuningDB) -> Dict[str, Any]:
        """One anti-entropy round: push ours, merge the service's back.

        Returns the service response; the service's pending re-tune
        requests are under ``"retune"`` for the caller (AntiEntropySync)
        to apply.
        """
        resp = self._call("sync", {"entries": db.export_entries()},
                          retries=self._degraded_retries())
        db.merge(resp.get("entries") or {})
        self.stats.syncs += 1
        self.stats.retunes_received += len(resp.get("retune") or {})
        return resp

    def demote(self, bp: BasicParams) -> Dict[str, Any]:
        return self._call("demote", {"bp": bp.asdict()},
                          retries=self._degraded_retries())

    # -- graceful-degradation variants ----------------------------------------

    def try_push(self, db: TuningDB, fingerprints: Optional[list] = None) -> bool:
        try:
            self.push(db, fingerprints)
            return True
        except ServiceUnavailable:
            return False

    def try_pull(self, bp: BasicParams,
                 match: Tuple[str, ...] = ("kernel",)) -> Optional[Dict[str, Any]]:
        try:
            return self.pull(bp, match)
        except ServiceUnavailable:
            return None

    def try_sync(self, db: TuningDB) -> Optional[Dict[str, Any]]:
        try:
            return self.sync(db)
        except ServiceUnavailable:
            return None

    def try_demote(self, bp: BasicParams) -> bool:
        try:
            self.demote(bp)
            return True
        except ServiceUnavailable:
            return False


# ---------------------------------------------------------------------------
# Host-side anti-entropy loop
# ---------------------------------------------------------------------------


class AntiEntropySync:
    """Periodic host <-> service reconciliation.

    Each :meth:`sync_once`:

    1. pushes the host's DB and merges the service's state back (one
       lattice-join round trip — after it, host ⊇ service-at-send-time and
       service ⊇ host-at-send-time, which is all eventual consistency
       needs);
    2. applies the service's pending **re-tune requests**: demote the
       fingerprint locally (so this host's dispatch fast path stops
       trusting the stale final) and, when a DriftMonitor plus a matching
       live op state are attached via :meth:`watch`, drive the full
       demote → background re-tune → canary lifecycle on this host too —
       drift seen by *one* host re-tunes the *fleet*.

    A failed round leaves the host fully functional on its local DB
    (``try_sync`` degrades, never raises); the next round is the reconnect
    probe.  ``start(interval_s)`` runs rounds on a daemon thread for
    long-lived processes; tests and the CLI call :meth:`sync_once`
    directly for determinism.
    """

    def __init__(
        self,
        client: ServiceClient,
        db: TuningDB,
        monitor: Optional[Any] = None,   # DriftMonitor (duck-typed)
        on_retune: Optional[Callable[[str, Dict[str, Any]], None]] = None,
    ) -> None:
        self.client = client
        self.db = db
        self.monitor = monitor
        self.on_retune = on_retune
        self._ops: List[Any] = []  # AutotunedOps whose states we can re-tune
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.rounds = 0
        self.failed_rounds = 0
        self.retunes_applied = 0

    def watch(self, op: Any) -> "AntiEntropySync":
        """Register an AutotunedOp whose live states re-tune on request."""
        self._ops.append(op)
        return self

    # -- one round -------------------------------------------------------------

    def sync_once(self) -> Dict[str, Any]:
        tr = current_tracer()
        if tr is None:
            return self._sync_once()
        with tr.span("fleet.sync", cat="fleet", round=self.rounds + 1) as attrs:
            res = self._sync_once()
            attrs["degraded"] = res["degraded"]
            attrs["retunes"] = res["retunes"]
            return res

    def _sync_once(self) -> Dict[str, Any]:
        self.rounds += 1
        resp = self.client.try_sync(self.db)
        if resp is None:
            self.failed_rounds += 1
            return {"ok": False, "degraded": True, "retunes": 0}
        applied = 0
        for fp, record in (resp.get("retune") or {}).items():
            if self._apply_retune(fp, record):
                applied += 1
        self.retunes_applied += applied
        return {"ok": True, "degraded": False, "retunes": applied,
                "entries": len(self.db.fingerprints())}

    def _apply_retune(self, fp: str, record: Dict[str, Any]) -> bool:
        """One service-side re-tune request landing on this host."""
        demoted = self.db.demote_fingerprint(fp)
        if self.on_retune is not None:
            try:
                self.on_retune(fp, record)
            except Exception:
                pass  # observer bugs must not break reconciliation
        if self.monitor is not None:
            for op, state in self._live_states(fp):
                if self.monitor.request_retune(op, state, reason="fleet"):
                    return True
        return demoted

    def _live_states(self, fp: str):
        for op in self._ops:
            for state in op.states().values():
                if state.bp.fingerprint() == fp:
                    yield op, state

    # -- background loop -------------------------------------------------------

    def start(self, interval_s: float = 30.0) -> "AntiEntropySync":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()

            def loop() -> None:
                while not self._stop.wait(interval_s):
                    self.sync_once()

            self._thread = threading.Thread(
                target=loop, name="repro-torch-anti-entropy", daemon=True
            )
            self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None


# ---------------------------------------------------------------------------
# HTTP face (stdlib only)
# ---------------------------------------------------------------------------


def service_registry(service: TuningService) -> "Any":
    """A MetricsRegistry pre-wired with the service's op counters and a
    DB-summary collector (entries, finals, quarantines, truncation)."""
    from ..obs.metrics import MetricsRegistry

    registry = MetricsRegistry()
    registry.register_stats(
        "tuning_service", service.stats,
        help="tuning-service op counters",
    )

    def _collect(reg: Any) -> None:
        from ..obs.explain import db_summary

        with service._lock:
            summary = db_summary(service.db)
        summary["retune_pending"] = len(service._retune)
        for k, v in summary.items():
            reg.gauge(f"tuning_db_{k}", help="tuning DB summary").set(v)

    registry.register_collector(_collect)
    return registry


def serve_http(service: TuningService, host: str = "127.0.0.1", port: int = 0,
               registry: Any = None):
    """Expose ``service`` on a ThreadingHTTPServer; returns the server.

    One route: ``POST /rpc`` with ``{"op": ..., "payload": ...}`` JSON,
    mirroring :meth:`TuningService.handle`; ``GET /health`` for probes and
    ``GET /metrics`` for a Prometheus text exposition of the service's op
    counters plus DB summary gauges (pass ``registry`` to expose a custom
    :class:`~repro_torch.obs.metrics.MetricsRegistry` instead).
    The server runs on a daemon thread — call ``server.shutdown()`` to
    stop.  ``port=0`` binds an ephemeral port (``server.server_address``).
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    metrics = registry if registry is not None else service_registry(service)

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, body: Dict[str, Any]) -> None:
            data = json.dumps(body, default=str).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _reply_text(self, code: int, text: str) -> None:
            data = text.encode()
            self.send_response(code)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self) -> None:  # noqa: N802 (stdlib naming)
            if self.path == "/health":
                self._reply(200, service.handle("health", {}))
            elif self.path == "/metrics":
                try:
                    self._reply_text(200, metrics.prometheus_text())
                except Exception as e:  # exposition must not kill the service
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self) -> None:  # noqa: N802
            if self.path != "/rpc":
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(length).decode())
                self._reply(200, service.handle(req.get("op", ""),
                                                req.get("payload") or {}))
            except Exception as e:  # a bad request must not kill the service
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, *args: Any) -> None:  # quiet CI logs
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    thread = threading.Thread(
        target=server.serve_forever, name="repro-torch-tuning-service", daemon=True
    )
    thread.start()
    return server
