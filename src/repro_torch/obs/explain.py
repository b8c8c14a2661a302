"""Tuning-decision explainability: reconstruct, from a :class:`TuningDB`,
*why* a shape class is running the candidate it is running.

The report assembles the full decision audit trail per entry —

* the BP echo and the emitted-space signature the final was searched under,
* warm-start seed provenance (``warm_start`` events: which sibling class
  seeded the search, at what BP distance),
* prescreen ranks vs. measured costs (``search_completed`` events record
  the cost-model ranking; ``trials`` holds what measurement then said),
* quarantine verdicts,
* the drift lifecycle (``space_invalidated``, demotions, canary events)
  and fleet adoption (``adopted_from_service``), where a DB holds them,
* the final best and how it got there.

This module may import ``repro_torch.core`` (unlike obs.trace/obs.metrics, which
sit below core in the import graph) — import it lazily from consumers.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from repro_torch.core.db import TOMBSTONE_KIND, TuningDB

__all__ = ["explain_fingerprint", "explain_all", "render_report", "db_summary"]

# Event kinds that are decisions (shown in full) vs. raw telemetry.
_DECISION_KINDS = (
    "warm_start", "search_completed", "space_invalidated", "demoted",
    "retune_scheduled", "canary_start", "promoted", "rolled_back",
    "adopted_from_service", TOMBSTONE_KIND,
)


def _entry(db: TuningDB, fingerprint: str) -> Dict[str, Any]:
    entry = db._data.get(fingerprint)
    if entry is None:
        raise KeyError(f"no DB entry for fingerprint {fingerprint!r}")
    return json.loads(json.dumps(entry, default=str))


def explain_fingerprint(db: TuningDB, fingerprint: str) -> Dict[str, Any]:
    """Structured decision report for one shape-class entry."""
    entry = _entry(db, fingerprint)
    bp = entry.get("bp", {})
    best = entry.get("best") or {}
    trials = entry.get("trials", {})
    events = entry.get("events", [])
    ranked_trials = sorted(trials.items(), key=lambda kv: (kv[1], kv[0]))
    by_kind: Dict[str, List[Dict[str, Any]]] = {}
    for ev in events:
        by_kind.setdefault(ev.get("kind", "?"), []).append(ev)

    search = (by_kind.get("search_completed") or [None])[-1]
    prescreen_rank = list(search.get("prescreen_rank", [])) if search else []
    measured_rank = [k for k, _ in ranked_trials]
    # how well the cost-model prescreen ordering predicted measurement:
    # position of the measured winner in the prescreen ranking (0 = agreed)
    winner_prescreen_pos = (
        prescreen_rank.index(measured_rank[0])
        if prescreen_rank and measured_rank and measured_rank[0] in prescreen_rank
        else None
    )

    final_point = best.get("point")
    source = "untuned"
    if best:
        if by_kind.get("adopted_from_service"):
            source = "adopted_from_service"
        elif best.get("final"):
            source = "local_search"
        elif best.get("demoted"):
            source = "demoted"
        else:
            source = "interim"

    return {
        "fingerprint": fingerprint,
        "kernel": bp.get("kernel"),
        "bp": bp,
        "layer": entry.get("layer"),
        "space_signature": best.get("space_sig"),
        "warm_start": (by_kind.get("warm_start") or [None])[-1],
        "search": search,
        "prescreen_rank": prescreen_rank,
        "measured_trials": [
            {"pp": k, "cost": c} for k, c in ranked_trials
        ],
        "winner_prescreen_pos": winner_prescreen_pos,
        "quarantined": entry.get("quarantined", {}),
        "decision_events": [
            ev for ev in events if ev.get("kind") in _DECISION_KINDS
        ],
        "events_truncated": (by_kind.get(TOMBSTONE_KIND) or [None])[-1],
        "runtime_observations": len(entry.get("history", [])),
        "final": {
            "point": final_point,
            "cost": best.get("cost"),
            "final": bool(best.get("final")),
            "demoted": bool(best.get("demoted")),
            "source": source,
        } if best else None,
    }


def explain_all(
    db: TuningDB, kernel: Optional[str] = None
) -> List[Dict[str, Any]]:
    """Reports for every entry (optionally one kernel/class), sorted by
    (kernel, fingerprint) so output order is deterministic."""
    out = []
    for fp in sorted(db.fingerprints()):
        entry = db._data.get(fp, {})
        if kernel is not None and entry.get("bp", {}).get("kernel") != kernel:
            continue
        out.append(explain_fingerprint(db, fp))
    out.sort(key=lambda r: (str(r.get("kernel")), r["fingerprint"]))
    return out


def _fmt_point(point: Any) -> str:
    if isinstance(point, dict):
        return json.dumps(point, sort_keys=True)
    return str(point)


def render_report(report: Dict[str, Any]) -> str:
    """Human-readable rendering of one :func:`explain_fingerprint` report:
    the decision chain in lifecycle order (emit signature -> warm start ->
    prescreen -> measured trials -> quarantines -> drift/canary events ->
    final)."""
    lines: List[str] = []
    lines.append(
        f"class {report.get('kernel') or '?'}  "
        f"[fingerprint {report['fingerprint'][:16]}]"
    )
    bp = {k: v for k, v in report.get("bp", {}).items() if k != "kernel"}
    lines.append(f"  BP: {_fmt_point(bp)}  (layer: {report.get('layer')})")
    sig = report.get("space_signature")
    lines.append(f"  emitted-space signature: {sig or '<none recorded>'}")

    ws = report.get("warm_start")
    if ws:
        lines.append(
            f"  warm start: seeded from {str(ws.get('source_fp'))[:16]} "
            f"(bp distance {ws.get('distance')}) -> {_fmt_point(ws.get('seed'))}"
        )
    else:
        lines.append("  warm start: none (cold search)")

    search = report.get("search")
    if search:
        lines.append(
            f"  search: {search.get('evaluations')} measured evaluations, "
            f"{search.get('prescreen_evaluations')} prescreen scores"
        )
        if report.get("prescreen_rank"):
            lines.append("  prescreen rank (cost model, best first):")
            for i, pp in enumerate(report["prescreen_rank"]):
                lines.append(f"    #{i}: {pp}")
    else:
        lines.append("  search: no search_completed event recorded")

    trials = report.get("measured_trials", [])
    if trials:
        lines.append(f"  measured trials ({len(trials)}, best first):")
        final = report.get("final") or {}
        winner_pp = _fmt_point(final.get("point")) if final.get("point") else None
        for i, t in enumerate(trials[:10]):
            mark = "  <- winner" if (
                winner_pp and _fmt_point(json.loads(t["pp"])) == winner_pp
            ) else ""
            lines.append(f"    #{i}: {t['pp']} @ {t['cost']:.3e}{mark}")
        if len(trials) > 10:
            lines.append(f"    ... {len(trials) - 10} more")
        pos = report.get("winner_prescreen_pos")
        if pos is not None:
            lines.append(
                f"  prescreen vs measurement: measured winner was "
                f"prescreen rank #{pos}"
            )
    else:
        lines.append("  measured trials: none")

    q = report.get("quarantined", {})
    if q:
        lines.append(f"  quarantined ({len(q)}):")
        for pp, rec in sorted(q.items()):
            lines.append(f"    {pp}: {rec.get('reason')}")

    tomb = report.get("events_truncated")
    if tomb:
        lines.append(
            f"  NOTE: {tomb.get('count')} older events truncated "
            f"(t {tomb.get('oldest_t')}..{tomb.get('newest_t')})"
        )
    evs = [
        ev for ev in report.get("decision_events", [])
        if ev.get("kind") not in ("warm_start", "search_completed",
                                  TOMBSTONE_KIND)
    ]
    if evs:
        lines.append(f"  lifecycle events ({len(evs)}):")
        for ev in evs:
            extra = {k: v for k, v in ev.items() if k not in ("kind", "t", "seq")}
            lines.append(f"    t={ev.get('t')}: {ev.get('kind')} {_fmt_point(extra)}")

    nobs = report.get("runtime_observations", 0)
    if nobs:
        lines.append(f"  run-time layer: {nobs} live observations recorded")

    final = report.get("final")
    if final:
        state = (
            "final" if final["final"] else
            "demoted" if final["demoted"] else "interim"
        )
        lines.append(
            f"  decision: {_fmt_point(final['point'])} @ {final['cost']:.3e} "
            f"({state}, via {final['source']})"
        )
    else:
        lines.append("  decision: none recorded")
    return "\n".join(lines)


def db_summary(db: TuningDB) -> Dict[str, float]:
    """Registry-ready roll-up of a DB's contents (the ``report`` subcommand
    and the service's ``/metrics`` gauge source)."""
    entries = len(db._data)
    finals = demoted = trials = quarantined = events = truncated = 0
    for entry in db._data.values():
        best = entry.get("best") or {}
        finals += 1 if best.get("final") else 0
        demoted += 1 if best.get("demoted") else 0
        trials += len(entry.get("trials", {}))
        quarantined += len(entry.get("quarantined", {}))
        evs = entry.get("events", [])
        events += len(evs)
        truncated += sum(
            int(e.get("count", 0)) for e in evs
            if e.get("kind") == TOMBSTONE_KIND
        )
    return {
        "entries": entries, "finals": finals, "demoted": demoted,
        "trials": trials, "quarantined": quarantined,
        "events": events, "events_truncated": truncated,
        "db_events": len(db.db_events()),
    }
