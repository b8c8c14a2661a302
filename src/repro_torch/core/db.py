"""Persistent tuning database (the port's own copy of the JAX package's).

It writes the same schema v2 envelope as the JAX package, so one file can
be read by either package.

FIBER's layered AT only works if results survive between layers: install-time
results are consulted at before-execution time, before-execution results at
run time.  ppOpen-AT persists them in generated source; we persist JSON, so
install-layer sweeps survive across *processes* — the registry's cross-run
cache (docs/registry.md) is just a TuningDB with a path.

On-disk layout (schema v2)::

    {
      "schema_version": 2,
      "entries": {
        "<bp_fingerprint>": {
           "bp": {...},                      # human-readable BP echo
           "layer": "before_execution",
           "best": {"point": {...}, "cost": 1.2e-3},
           "trials": {"<pp_key>": cost, ...},
           "quarantined": {"<pp_key>": {...}}, # broken-measurement markers
           "history": [...],                 # run-time layer observations
           "events": [...]                   # drift/canary audit log (docs/fleet.md)
        }, ...
      },
      "db_events": [...]                     # DB-level audit (salvage recoveries)
    }

Schema v1 (the seed format) was the bare ``entries`` mapping with no
envelope; :meth:`TuningDB.load` still reads it.

Writes are atomic (tmp + rename) so a crashed AT run never corrupts the DB —
the same discipline the checkpointing layer uses.  Each flush additionally
keeps the previous good flush as ``<path>.bak``, and loading salvages from
it when the main file is torn or missing (the recovery is logged in
``db_events``).  Every flush first merges the on-disk state into the
in-memory view, so concurrent writers (e.g. two install-layer sweeps over
disjoint shape classes) union rather than clobber.
"""
from __future__ import annotations

import json
import math
import os
import tempfile
import threading
import time
from typing import Any, Dict, Mapping, Optional, Tuple

from .params import BasicParams, pp_key

SCHEMA_VERSION = 2

# Run-time observations are telemetry, not results: keep a bounded window
# per entry and flush them to disk only every Nth record, so a long-running
# server's per-group observe() neither grows the file without bound nor
# pays a full-DB rewrite on its hot path.  Trials/bests still flush on
# every write (losing one would lose a search result).
HISTORY_LIMIT = 256
RUNTIME_FLUSH_EVERY = 16

# Tuning events (demotions, canary verdicts — docs/fleet.md) are the audit
# trail, rare and precious: bounded higher-level, flushed on every record.
# Overflow is never silent: the dropped oldest prefix is folded into one
# ``events_truncated`` tombstone (count + oldest/newest timestamps) that
# merge joins canonically (see _trim_events / _join_tombstones).
EVENT_LIMIT = 256
TOMBSTONE_KIND = "events_truncated"


class _SchemaTooNew(ValueError):
    """On-disk schema newer than this code: never salvage over it."""


class TuningDB:
    SCHEMA_VERSION = SCHEMA_VERSION

    def __init__(self, path: Optional[str] = None) -> None:
        self.path = path
        self._lock = threading.Lock()
        self._data: Dict[str, Dict[str, Any]] = {}
        self._db_events: list = []
        self._disk_sig: Optional[Tuple[int, int]] = None
        self._runtime_obs = 0
        self._event_seq = 0
        if path and (os.path.exists(path) or os.path.exists(path + ".bak")):
            self._data, self._db_events = self._load_salvaging(path)
            self._disk_sig = self._file_sig(path)

    # -- persistence ---------------------------------------------------------

    @classmethod
    def load(cls, path: str) -> "TuningDB":
        """Open (or create) a DB bound to ``path``."""
        return cls(path)

    def save(self, path: Optional[str] = None) -> str:
        """Write the DB to ``path`` (defaults to the bound path) atomically.

        Binds the DB to ``path`` for subsequent auto-flushes.
        """
        with self._lock:
            if path is not None:
                self.path = path
            if not self.path:
                raise ValueError("TuningDB.save() needs a path")
            self._flush()
            return self.path

    def merge(self, other: "TuningDB | Mapping[str, Dict[str, Any]]") -> "TuningDB":
        """Union another DB's entries into this one.

        Conflict policy (concurrent writers are additive, never destructive):
        trial costs keep the *minimum* observed cost per PP point, ``best``
        keeps the lower-cost record, histories concatenate.
        """
        entries = other._data if isinstance(other, TuningDB) else dict(other)
        with self._lock:
            _merge_entries(self._data, entries)
        return self

    def export_entries(
        self, fingerprints: Optional[list] = None
    ) -> Dict[str, Dict[str, Any]]:
        """A deep, JSON-safe copy of (some) entries — the service wire form.

        This is what a fleet host *pushes* to the global tuning service
        (docs/fleet.md): the snapshot round-trips through ``json`` exactly
        like the on-disk format, and feeding it to :meth:`merge` on any
        receiver is the idempotent lattice join — safe to retry, duplicate,
        or reorder in flight.
        """
        with self._lock:
            keys = self._data.keys() if fingerprints is None else [
                fp for fp in fingerprints if fp in self._data
            ]
            return {
                fp: json.loads(json.dumps(self._data[fp], default=str))
                for fp in keys
            }

    # -- write ---------------------------------------------------------------

    def record_trial(
        self, bp: BasicParams, point: Mapping[str, Any], cost: float, layer: str
    ) -> None:
        if not math.isfinite(cost):
            # measurement guardrail: a NaN/inf trial is a broken measurement,
            # not a slow one — quarantine it instead of letting NaN poison
            # the running best (NaN comparisons are always False, so a NaN
            # cost would silently survive min/argmin logic)
            self.record_quarantine(
                bp, point, f"non-finite trial cost {cost!r}", layer=layer
            )
            return
        with self._lock:
            entry = self._entry(bp, layer)
            entry["trials"][pp_key(point)] = cost
            best = entry.get("best")
            if best is None or cost < best["cost"]:
                entry["best"] = {"point": dict(point), "cost": cost}
            self._flush()

    def record_best(
        self, bp: BasicParams, point: Mapping[str, Any], cost: float, layer: str,
        space_signature: Optional[str] = None,
    ) -> None:
        """Record the argmin of a *completed* search.

        ``record_trial`` keeps a running best for crash robustness, but only
        this call marks the entry ``final`` — the registry's zero-re-tune
        fast path (``tuned_point``) trusts finals only, so an interrupted or
        budget-capped sweep resumes instead of freezing its interim winner.

        ``space_signature`` stamps the final with the emitted-space content
        hash it was searched under (core/emit.py); ``tuned_point`` callers
        that pass their current signature then refuse finals from a
        different emission — a changed arch model re-tunes instead of
        recalling a winner from a space that no longer exists.
        """
        if not math.isfinite(cost):
            raise ValueError(
                f"record_best: non-finite cost {cost!r} for {pp_key(point)} — "
                "quarantined candidates can never become a final best"
            )
        with self._lock:
            entry = self._entry(bp, layer)
            best = {"point": dict(point), "cost": cost, "final": True}
            if space_signature is not None:
                best["space_sig"] = str(space_signature)
            entry["best"] = best
            self._flush()

    def record_quarantine(
        self,
        bp: BasicParams,
        point: Mapping[str, Any],
        reason: str,
        layer: Optional[str] = None,
    ) -> None:
        """Mark one PP point as producing broken measurements.

        A quarantined point is barred from the zero-re-tune fast path
        (:meth:`tuned_point` refuses a best that sits on it) and from
        cross-class warm starts, and :meth:`merge` unions the markers, so a
        candidate that NaN'd on one fleet host is distrusted fleet-wide.
        """
        with self._lock:
            entry = self._entry(bp, layer)
            q = entry.setdefault("quarantined", {})
            q[pp_key(point)] = {"point": dict(point), "reason": str(reason)}
            self._flush()

    def record_runtime_observation(
        self, bp: BasicParams, point: Mapping[str, Any], cost: float
    ) -> None:
        """Run-time layer: append a measured (point, cost) observation.

        History is a bounded window (``HISTORY_LIMIT``) flushed every
        ``RUNTIME_FLUSH_EVERY`` records — observations are telemetry, and a
        crash losing a few of them is harmless, unlike trials/bests.
        """
        with self._lock:
            entry = self._entry(bp, "run_time")
            hist = entry.setdefault("history", [])
            hist.append({"point": dict(point), "cost": cost})
            if len(hist) > HISTORY_LIMIT:
                del hist[: len(hist) - HISTORY_LIMIT]
            self._runtime_obs += 1
            if self._runtime_obs % RUNTIME_FLUSH_EVERY == 0:
                self._flush()

    def record_event(self, bp: BasicParams, kind: str, **payload: Any) -> Dict[str, Any]:
        """Append one audit event to this entry's tuning-event log.

        The drift/canary lifecycle (docs/fleet.md) records every transition
        — ``demoted``, ``retune_scheduled``, ``canary_start``, ``promoted``,
        ``rolled_back`` — so an operator can reconstruct why a host is
        running the candidate it is running.  Events carry a wall-clock
        ``t`` plus a per-process ``seq`` so a merged log orders
        deterministically (see :func:`_merge_entries`).
        """
        with self._lock:
            entry = self._entry(bp)
            events = entry.setdefault("events", [])
            self._event_seq += 1
            ev = {"kind": str(kind), "t": round(time.time(), 6),
                  "seq": self._event_seq, **payload}
            events.append(ev)
            if len(events) > EVENT_LIMIT:
                # never drop silently: the overflowed prefix folds into a
                # single ``events_truncated`` tombstone (count + ts range)
                entry["events"] = _trim_events(events, EVENT_LIMIT)
            self._flush()
            return dict(ev)

    def demote_best(self, bp: BasicParams) -> bool:
        """Strip the ``final`` flag from this entry's best (drift demotion).

        The record itself survives (it is still the best *measured* result)
        but ``tuned_point`` stops trusting it, so every consumer of the
        zero-re-tune fast path re-enters tuning instead of freezing a
        winner the runtime has drifted away from.  The record is marked
        ``demoted`` so *flush-time reconciliation* (this process's own
        writes racing the disk) does not resurrect the final flag from a
        stale on-disk copy of the same point.  A symmetric ``merge`` with a
        foreign DB that still holds the pre-demotion final CAN re-promote
        it — finality wins there by design, because merge must stay a
        commutative join and a foreign final is usually a genuinely newer
        completed search; if the regression persists, the drift watch
        simply demotes again (docs/fleet.md).  Returns True when a final
        best was actually demoted.
        """
        return self.demote_fingerprint(bp.fingerprint())

    def demote_fingerprint(self, fingerprint: str) -> bool:
        """:meth:`demote_best` addressed by raw DB fingerprint.

        The global tuning service and the anti-entropy sync loop
        (docs/fleet.md) propagate demotions as fingerprints — the receiver
        may never have constructed the BasicParams object, only merged the
        entry — so demotion must work from the key alone.
        """
        with self._lock:
            entry = self._data.get(fingerprint)
            best = entry.get("best") if entry else None
            if not best or not best.get("final"):
                return False
            best.pop("final", None)
            best["demoted"] = True
            self._flush()
            return True

    # -- read ----------------------------------------------------------------

    def events(self, bp: BasicParams) -> list:
        """The persisted tuning-event log for this entry (audit order)."""
        entry = self._data.get(bp.fingerprint(), {})
        return [dict(e) for e in entry.get("events", [])]

    def best_point(self, bp: BasicParams) -> Optional[Dict[str, Any]]:
        entry = self._data.get(bp.fingerprint())
        if entry and entry.get("best"):
            return dict(entry["best"]["point"])
        return None

    def tuned_point(
        self, bp: BasicParams, space_signature: Optional[str] = None
    ) -> Optional[Dict[str, Any]]:
        """The best point, only if it came from a completed search and has
        not been quarantined (a merge can carry in a foreign final whose
        point a later measurement quarantined — distrust wins).

        When the caller passes its current emitted-space ``space_signature``,
        the final must carry the *same* signature to be trusted: a final
        recorded under a different (or no) signature was searched over a
        space that no longer exists, so recalling it would freeze a winner
        the current arch model may not even emit.  ``None`` keeps the
        legacy behaviour for hand-built spaces.
        """
        entry = self._data.get(bp.fingerprint())
        if entry and entry.get("best") and entry["best"].get("final"):
            best = entry["best"]
            if (space_signature is not None
                    and best.get("space_sig") != space_signature):
                return None
            point = best["point"]
            if pp_key(point) in entry.get("quarantined", {}):
                return None
            return dict(point)
        return None

    def space_signature(self, bp: BasicParams) -> Optional[str]:
        """The emitted-space signature the recorded final was searched under."""
        entry = self._data.get(bp.fingerprint())
        if entry and entry.get("best"):
            sig = entry["best"].get("space_sig")
            return None if sig is None else str(sig)
        return None

    def invalidate_stale_final(
        self, bp: BasicParams, space_signature: str
    ) -> bool:
        """Demote a final whose emitted-space signature no longer matches.

        The arch model changed (or the emit policy did), so the recorded
        winner came from a space that is no longer the one being tuned:
        strip the ``final`` flag, drop the stale trials (they would poison
        warm starts and runtime re-ranking with points the new space may
        not contain), and append a ``space_invalidated`` audit event.
        Returns True when a stale final was actually invalidated.
        """
        with self._lock:
            entry = self._data.get(bp.fingerprint())
            best = entry.get("best") if entry else None
            if not best or not best.get("final"):
                return False
            old_sig = best.get("space_sig")
            if old_sig == space_signature:
                return False
            best.pop("final", None)
            best["demoted"] = True
            entry["trials"] = {}
            self._flush()
        self.record_event(
            bp, "space_invalidated",
            old_sig=old_sig, new_sig=space_signature,
        )
        return True

    def quarantined(self, bp: BasicParams) -> Dict[str, Dict[str, Any]]:
        """The quarantine markers for this entry (pp_key → record)."""
        entry = self._data.get(bp.fingerprint(), {})
        return {k: dict(v) for k, v in entry.get("quarantined", {}).items()}

    def is_quarantined(self, bp: BasicParams, point: Mapping[str, Any]) -> bool:
        entry = self._data.get(bp.fingerprint(), {})
        return pp_key(point) in entry.get("quarantined", {})

    def best_cost(self, bp: BasicParams) -> Optional[float]:
        entry = self._data.get(bp.fingerprint())
        if entry and entry.get("best"):
            return float(entry["best"]["cost"])
        return None

    def trial_cost(self, bp: BasicParams, point: Mapping[str, Any]) -> Optional[float]:
        entry = self._data.get(bp.fingerprint())
        if entry:
            c = entry.get("trials", {}).get(pp_key(point))
            return None if c is None else float(c)
        return None

    def trials(self, bp: BasicParams) -> Dict[str, float]:
        entry = self._data.get(bp.fingerprint(), {})
        return dict(entry.get("trials", {}))

    def history(self, bp: BasicParams) -> list:
        entry = self._data.get(bp.fingerprint(), {})
        return list(entry.get("history", []))

    def fingerprints(self) -> list:
        return list(self._data)

    def entries_matching(self, **bp_filter: Any) -> Dict[str, Dict[str, Any]]:
        """Entries whose BP echo matches every given ``key=value``.

        This is the query surface that makes composed BP dimensions —
        traffic class, mesh fingerprint — first-class: e.g.
        ``db.entries_matching(phase="prefill", mesh="data2xmodel2")``.
        """
        out: Dict[str, Dict[str, Any]] = {}
        with self._lock:
            for fp, entry in self._data.items():
                bp = entry.get("bp", {})
                if all(bp.get(k) == v for k, v in bp_filter.items()):
                    out[fp] = json.loads(json.dumps(entry))
        return out

    def nearest_tuned(
        self,
        bp: BasicParams,
        match: Tuple[str, ...] = ("kernel",),
    ) -> Optional[Dict[str, Any]]:
        """The completed search nearest to ``bp`` among sibling shape classes.

        The cross-shape-class warm start (docs/tuning.md): an untuned class
        looks up the already-tuned entry with the same value for every
        ``match`` key (same kernel by default) and the smallest BP-echo
        distance — numeric dimensions compare on a log2 scale (bucket
        distance: seq 256 is one bucket from 512, not 256 away), any other
        mismatch costs 1.  Only *final* bests qualify (an interim winner
        from a crashed sweep must not seed refinement), and the entry for
        ``bp`` itself never matches.

        Returns ``{"point", "cost", "bp", "distance"}`` or ``None``.
        """
        target = _json_roundtrip(bp.asdict())
        if any(k not in target for k in match):
            return None
        own_fp = bp.fingerprint()
        best: Optional[Dict[str, Any]] = None
        with self._lock:
            for fp, entry in self._data.items():
                if fp == own_fp:
                    continue
                rec = entry.get("best")
                if not rec or not rec.get("final"):
                    continue
                if pp_key(rec.get("point", {})) in entry.get("quarantined", {}):
                    continue  # a distrusted winner must not seed warm starts
                echo = _json_roundtrip(entry.get("bp", {}))
                if any(echo.get(k) != target[k] for k in match):
                    continue
                d = _bp_distance(target, echo, skip=match)
                if best is None or d < best["distance"]:
                    best = {
                        "point": dict(rec["point"]),
                        "cost": float(rec["cost"]),
                        "bp": echo,
                        "distance": d,
                        "fingerprint": fp,
                    }
        return best

    def traffic_classes(self) -> list:
        """Distinct serving traffic classes present in the DB, sorted by label.

        Scans BP echoes for the :meth:`TrafficClass.bp_entries` keys; entries
        without them (plain kernels) are skipped.
        """
        from .traffic import TrafficClass

        seen: Dict[str, Any] = {}
        with self._lock:
            for entry in self._data.values():
                bp = entry.get("bp", {})
                if all(k in bp for k in TrafficClass.BP_KEYS):
                    tc = TrafficClass.from_bp_entries(bp)
                    seen[tc.label] = tc
        return [seen[k] for k in sorted(seen)]

    def devices(self) -> list:
        """Distinct device fingerprints present in the DB, sorted by label.

        The fleet-merge counterpart of :meth:`traffic_classes`: after
        ``TuningDB.merge`` unions DBs from heterogeneous hosts, this lists
        which devices contributed entries.  Entries without the
        :class:`~repro_torch.fleet.DeviceFingerprint` BP keys (single-host
        DBs) are skipped.
        """
        from ..fleet.fingerprint import DeviceFingerprint

        seen: Dict[str, Any] = {}
        with self._lock:
            for entry in self._data.values():
                bp = entry.get("bp", {})
                if all(k in bp for k in DeviceFingerprint.BP_KEYS):
                    df = DeviceFingerprint.from_bp_entries(bp)
                    seen[df.label] = df
        return [seen[k] for k in sorted(seen)]

    # -- internals -------------------------------------------------------------

    @staticmethod
    def _read_raw(path: str) -> Any:
        with open(path) as f:
            raw = json.load(f)
        if isinstance(raw, dict) and "schema_version" in raw:
            version = raw["schema_version"]
            if version > SCHEMA_VERSION:
                raise _SchemaTooNew(
                    f"TuningDB {path}: schema v{version} is newer than "
                    f"supported v{SCHEMA_VERSION}"
                )
        return raw

    @classmethod
    def _read_file(cls, path: str) -> Dict[str, Dict[str, Any]]:
        raw = cls._read_raw(path)
        if isinstance(raw, dict) and "schema_version" in raw:
            return dict(raw.get("entries", {}))
        return dict(raw)  # legacy v1: bare entries mapping

    @classmethod
    def _load_salvaging(cls, path: str) -> Tuple[Dict[str, Dict[str, Any]], list]:
        """Load ``path``, falling back to its ``.bak`` (the previous good
        flush) when the main file is truncated/corrupt or missing.

        A flush that died mid-write leaves either a torn main file (the
        pre-atomic-rename legacy) or — with the two-step rename — a good
        ``.bak`` and no main file.  Either way the last *completed* flush
        survives, and the recovery is logged in the persisted ``db_events``
        list so an operator can see data was salvaged (and roughly how much
        was lost).  A schema-too-new error still raises: that is an operator
        mistake, not a crash to paper over.
        """
        bak = path + ".bak"
        try:
            raw = cls._read_raw(path)
            events = list(raw.get("db_events", [])) if (
                isinstance(raw, dict) and "schema_version" in raw
            ) else []
            return cls._entries_of(raw), events
        except _SchemaTooNew:
            raise
        except (json.JSONDecodeError, OSError, TypeError, ValueError) as exc:
            err = f"{type(exc).__name__}: {exc}"
        try:
            raw = cls._read_raw(bak)
            events = list(raw.get("db_events", [])) if (
                isinstance(raw, dict) and "schema_version" in raw
            ) else []
            entries = cls._entries_of(raw)
        except _SchemaTooNew:
            raise
        except (json.JSONDecodeError, OSError, TypeError, ValueError) as bak_exc:
            # neither file readable: start empty, but leave the audit trail
            return {}, [{
                "kind": "db_salvage_failed", "t": round(time.time(), 6),
                "error": err, "bak_error": f"{type(bak_exc).__name__}: {bak_exc}",
            }]
        events.append({
            "kind": "db_salvaged", "t": round(time.time(), 6),
            "source": os.path.basename(bak), "error": err,
            "entries": len(entries),
        })
        return entries, events

    @staticmethod
    def _entries_of(raw: Any) -> Dict[str, Dict[str, Any]]:
        if isinstance(raw, dict) and "schema_version" in raw:
            return dict(raw.get("entries", {}))
        return dict(raw)  # legacy v1: bare entries mapping

    def db_events(self) -> list:
        """DB-level audit events (salvage recoveries), persisted across
        flushes — distinct from per-entry tuning events."""
        with self._lock:
            return [dict(e) for e in self._db_events]

    def _entry(self, bp: BasicParams, layer: Optional[str] = None) -> Dict[str, Any]:
        fp = bp.fingerprint()
        if fp not in self._data:
            self._data[fp] = {
                "bp": bp.asdict(), "layer": layer or "run_time", "trials": {}
            }
        if layer is not None:  # event writes must not clobber the layer tag
            self._data[fp]["layer"] = layer
        return self._data[fp]

    @staticmethod
    def _file_sig(path: str) -> Optional[Tuple[int, int]]:
        try:
            st = os.stat(path)
            return (st.st_mtime_ns, st.st_size)
        except OSError:
            return None

    def _flush(self) -> None:
        """Atomically persist; caller must hold the lock.

        If the file changed under us (a concurrent writer), its entries are
        merged in first with *our* values winning on conflict — our in-memory
        costs are fresh measurements, the disk's may be stale; the other
        writer's shape classes and unknown points are adopted wholesale.  The
        mtime/size signature skips the re-read entirely in the common
        single-writer case (no O(file) read per trial).
        """
        if not self.path:
            return
        if os.path.exists(self.path) and self._file_sig(self.path) != self._disk_sig:
            try:
                _merge_entries(self._data, self._read_file(self.path),
                               prefer_ours=True)
            except (json.JSONDecodeError, OSError):
                pass  # half-written foreign file; keep our view
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(
                    {"schema_version": SCHEMA_VERSION, "entries": self._data,
                     "db_events": self._db_events},
                    f, indent=1, default=str,
                )
            # keep the outgoing file as the last-good-flush backup before
            # promoting the new one: a crash in the window between the two
            # renames leaves a good .bak and no main file, which
            # _load_salvaging recovers (logged as a db_salvaged event)
            if os.path.exists(self.path):
                os.replace(self.path, self.path + ".bak")
            os.replace(tmp, self.path)
            self._disk_sig = self._file_sig(self.path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)


def _json_roundtrip(d: Mapping[str, Any]) -> Dict[str, Any]:
    """Normalize a BP dict the way on-disk entries are stored (tuples become
    lists, exotic scalars become strings) so live and loaded echoes compare."""
    return json.loads(json.dumps(dict(d), default=str))


def _is_number(v: Any) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _bp_distance(
    a: Mapping[str, Any], b: Mapping[str, Any], skip: Tuple[str, ...] = ()
) -> float:
    """Shape-class distance between two BP echoes.

    Numeric dimensions are compared as ``|log2(a) - log2(b)|`` — one
    power-of-two bucket apart costs 1 — everything else (missing keys,
    non-numeric mismatches like dtype or phase) costs a flat 1 per key.
    """
    d = 0.0
    for key in set(a) | set(b):
        if key in skip:
            continue
        va, vb = a.get(key), b.get(key)
        if va == vb:
            continue
        if _is_number(va) and _is_number(vb):
            d += abs(
                math.log2(max(abs(va), 1e-12)) - math.log2(max(abs(vb), 1e-12))
            )
        else:
            d += 1.0
    return d


def _merge_entries(
    into: Dict[str, Dict[str, Any]],
    other: Mapping[str, Dict[str, Any]],
    prefer_ours: bool = False,
) -> None:
    """Union ``other`` into ``into``.

    Symmetric mode (``prefer_ours=False``, the public ``merge``) is a
    *deterministic lattice join* — commutative, associative, idempotent —
    because the fleet sync barrier (docs/fleet.md) must produce the same
    merged DB no matter which worker's scratch results land first:

    * trial costs keep the minimum per PP point;
    * for bests a *final* record beats a non-final one regardless of cost —
      an interim best from a crashed sweep must never displace a completed
      search's argmin; among equal finality lower cost wins, and an exact
      cost tie breaks on the records' canonical JSON so merge order cannot
      pick the winner;
    * histories and event logs become sorted unions (dedup by canonical
      JSON; events order by their ``(t, seq)`` stamps) — order-insensitive
      telemetry, deterministically arranged.

    ``prefer_ours=True`` (flush-time reconciliation) only adopts shape
    classes / trial points / bests we don't already have: our values are
    fresh measurements, the disk's may be stale.
    """
    for fp, theirs in other.items():
        ours = into.get(fp)
        if ours is None:
            into[fp] = json.loads(json.dumps(theirs, default=str))  # deep copy
            continue
        # the layer tag is informational; merge to the furthest FIBER layer
        # either writer reached so the join stays order-independent
        if _LAYER_ORDER.get(theirs.get("layer"), -1) > _LAYER_ORDER.get(
            ours.get("layer"), -1
        ):
            ours["layer"] = theirs["layer"]
        trials = ours.setdefault("trials", {})
        for key, cost in theirs.get("trials", {}).items():
            if key not in trials:
                trials[key] = cost
            elif not prefer_ours and cost < trials[key]:
                trials[key] = cost
        their_best = theirs.get("best")
        if their_best is not None and _best_beats(
            their_best, ours.get("best"), prefer_ours
        ):
            ours["best"] = json.loads(json.dumps(their_best, default=str))
        # quarantine markers union (distrust is sticky fleet-wide); on a
        # same-key conflict the canonically smaller record wins so the join
        # stays commutative
        their_q = theirs.get("quarantined", {})
        if their_q:
            q = ours.setdefault("quarantined", {})
            for key, rec in their_q.items():
                rec_copy = json.loads(json.dumps(rec, default=str))
                if key not in q:
                    q[key] = rec_copy
                elif not prefer_ours and _canon(rec_copy) < _canon(q[key]):
                    q[key] = rec_copy
        for field, key, limit in _LOG_FIELDS:
            _union_log(ours, theirs, field, limit, key)
    if not prefer_ours:
        # normalize every result entry's logs (including receiver-only and
        # freshly adopted ones): a merged DB is a canonical form, so any
        # order/grouping of the same inputs is byte-identical.  Flush-time
        # reconciliation skips this — it runs per trial write on the hot
        # tuning path and has no order-independence contract to keep.
        for entry in into.values():
            for field, key, _limit in _LOG_FIELDS:
                if entry.get(field):
                    entry[field].sort(key=key)


_LAYER_ORDER = {"install": 0, "before_execution": 1, "run_time": 2}


def _canon(obj: Any) -> str:
    return json.dumps(obj, sort_keys=True, default=str)


# (field, sort key, bound) for each append-only log a DB entry can carry.
# Events order by their (wall clock, per-process seq) stamps so a merged
# audit log reads in lifecycle order; history has no stamps and orders
# canonically (it is an order-insensitive telemetry window).
_LOG_FIELDS = (
    ("history", _canon, HISTORY_LIMIT),
    ("events",
     lambda e: (e.get("t", 0.0), e.get("seq", 0), _canon(e)),
     EVENT_LIMIT),
)


def _is_tombstone(ev: Any) -> bool:
    return isinstance(ev, dict) and ev.get("kind") == TOMBSTONE_KIND


def _join_tombstones(tombs: list) -> Optional[Dict[str, Any]]:
    """Lattice join of truncation tombstones: count takes the maximum (two
    hosts that truncated divergent copies of a shared log overlap, so
    summing would double-count), the covered timestamp range widens to
    ``[min(oldest), max(newest)]``.  The ``(t=0.0, seq=0)`` stamp pins the
    tombstone first under the event sort key (real events carry wall-clock
    stamps), so a merged log always leads with its loss marker."""
    if not tombs:
        return None
    tomb: Dict[str, Any] = {
        "kind": TOMBSTONE_KIND, "t": 0.0, "seq": 0,
        "count": max(int(t.get("count", 0)) for t in tombs),
    }
    oldest = [float(t["oldest_t"]) for t in tombs if "oldest_t" in t]
    newest = [float(t["newest_t"]) for t in tombs if "newest_t" in t]
    if oldest:
        tomb["oldest_t"] = min(oldest)
    if newest:
        tomb["newest_t"] = max(newest)
    return tomb


def _trim_events(events: list, limit: int) -> list:
    """Bound an event log to ``limit`` records without silent loss: the
    dropped oldest prefix folds into a single ``events_truncated`` tombstone
    carrying the drop count and the timestamp range it covered.  Existing
    tombstones (from earlier trims, or several carried in by a merge) are
    first joined into one; newly dropped events then *accumulate* onto it —
    a sequential fold, which is exact for the single-writer append path.
    """
    tombs = [e for e in events if _is_tombstone(e)]
    real = [e for e in events if not _is_tombstone(e)]
    tomb = _join_tombstones(tombs)
    keep = limit - 1 if (tomb is not None or len(real) > limit) else limit
    if len(real) > keep:
        drop = real[: len(real) - keep]
        real = real[len(real) - keep:]
        if tomb is None:
            tomb = {"kind": TOMBSTONE_KIND, "t": 0.0, "seq": 0, "count": 0}
        ts = [float(e.get("t", 0.0)) for e in drop]
        tomb["count"] = int(tomb.get("count", 0)) + len(drop)
        tomb["oldest_t"] = round(min([tomb.get("oldest_t", ts[0])] + ts), 6)
        tomb["newest_t"] = round(max([tomb.get("newest_t", ts[0])] + ts), 6)
    return ([tomb] if tomb is not None else []) + real


def _union_log(
    ours: Dict[str, Any],
    theirs: Mapping[str, Any],
    field: str,
    limit: int,
    key,
) -> None:
    """Sorted max-multiplicity union of one append-only log field.

    Logs are multisets (the same observation can legitimately repeat), so
    the join takes each distinct record at the *maximum* multiplicity seen
    on either side — the multiset operation that is commutative,
    associative, and idempotent — then sorts deterministically.  Plain
    concat-dedup is neither: a record duplicated on one side would survive
    or collapse depending on merge direction.

    Truncation tombstones in the events log are lifted out of the multiset
    and joined on their own lattice (:func:`_join_tombstones`) — treating
    them as ordinary records would let divergently truncated logs keep two
    conflicting loss markers.
    """
    counts: Dict[str, int] = {}
    tombs: list = []
    for log in (ours.get(field, []), theirs.get(field, [])):
        side: Dict[str, int] = {}
        for h in log:
            if field == "events" and _is_tombstone(h):
                tombs.append(h)
                continue
            c = _canon(h)
            side[c] = side.get(c, 0) + 1
        for c, n in side.items():
            counts[c] = max(counts.get(c, 0), n)
    if not counts and not tombs:
        return  # neither side has this log: don't materialize an empty one
    merged = [json.loads(c) for c, n in counts.items() for _ in range(n)]
    merged.sort(key=key)
    tomb = _join_tombstones(tombs)
    if tomb is not None:
        merged.insert(0, tomb)
    if len(merged) > limit:
        merged = (
            _trim_events(merged, limit) if field == "events"
            else merged[len(merged) - limit:]
        )
    ours[field] = merged


def _best_beats(
    theirs: Dict[str, Any], ours: Optional[Dict[str, Any]], prefer_ours: bool
) -> bool:
    if ours is None:
        return True
    if prefer_ours:
        # flush reconciliation: keep our record unless the other writer
        # actually *finished* a search we haven't (our record_best, when it
        # comes, overwrites unconditionally anyway).  A best we *demoted*
        # (drift) must not have its final flag resurrected by the stale
        # on-disk copy of the very same point.
        if ours.get("demoted") and theirs.get("point") == ours.get("point"):
            return False
        return bool(theirs.get("final")) and not bool(ours.get("final"))
    if bool(theirs.get("final")) != bool(ours.get("final")):
        return bool(theirs.get("final"))
    if theirs["cost"] != ours["cost"]:
        return theirs["cost"] < ours["cost"]
    # exact tie: break on canonical JSON so A.merge(B) == B.merge(A)
    return _canon(theirs) < _canon(ours)
