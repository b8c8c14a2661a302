"""Drift detection + canary promotion.

The port's copy of ``repro.fleet.drift``: the same lifecycle, the same
event log.  What differs is what it is fed.  The recorded final's cost is
the tuner's measurement, CUDA-event device time on a card, so
:class:`~repro_torch.core.autotuned.AutotunedOp` times its sampled calls on
CUDA tensors with CUDA events too: a host-clock time would carry the
wrapper's Python, the launch and the synchronise, more than ``factor``
times a small kernel's cost on a healthy run.  A serve step is observed
on the host clock around the synchronised step, against a cost the tuner
timed with events around the whole step; the two differ by the step's
first launch and its synchronise, small beside a step of many launches.

Mametjanov & Norris (arXiv:1309.1894) argue autotuning is a *sustained*
process: the environment drifts (thermal throttling, noisy neighbours,
driver updates), and a winner tuned yesterday can silently regress.  Our
dispatch fast path already feeds a trickle of measured call times to the
run-time layer (``monitor_every``); this module turns that trickle into a
supervised re-tuning lifecycle:

* **watch** — per shape class, an EWMA of observed cost.  While a *final*
  best is live and the EWMA exceeds its recorded cost by ``factor``, the
  class has drifted: the final is **demoted** in the DB
  (:meth:`~repro_torch.core.db.TuningDB.demote_best`) so no fresh process freezes
  the stale winner, and a **re-tune is scheduled** — on the
  :class:`~repro_torch.runtime.background_tuner.BackgroundTuner` worker when one
  is attached (the hot path never pays search cost), inline otherwise.

* **re-tune** — a *fresh* re-measure of the space
  (:meth:`AutotunedOp.retune_state`): recorded trial costs are exactly what
  reality drifted away from, so the cache must not short-circuit.

* **canary** — the challenger is selected *provisionally* (the region hot
  swaps, nothing is recorded final) for ``canary_window`` observations.  If
  its median observed cost beats what the incumbent was actually delivering
  (``incumbent_observed * canary_margin``) it is **promoted** — recorded as
  the new final best at its *observed* cost.  Otherwise it **rolls back**:
  the incumbent is re-selected and re-finalized at its observed cost, so
  the recorded expectation matches reality and the watch doesn't
  immediately re-trip.

Every transition lands in the DB's persisted tuning-event log
(``demoted`` → ``retune_scheduled`` → ``canary_start`` → ``promoted`` /
``rolled_back``, plus ``retune_failed``), the audit trail an operator —
or a test — replays to see why a host runs what it runs.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ..core.autotuned import AutotunedOp, OpState


@dataclass
class _Watch:
    """Per-shape-class drift state machine."""

    phase: str = "healthy"  # healthy -> retuning -> canary -> healthy
    ewma: Optional[float] = None
    n: int = 0
    incumbent: Optional[Dict[str, Any]] = None
    incumbent_observed: float = 0.0
    challenger: Optional[Dict[str, Any]] = None
    canary_costs: List[float] = field(default_factory=list)

    def reset(self) -> None:
        self.phase = "healthy"
        self.ewma = None
        self.n = 0
        self.incumbent = None
        self.challenger = None
        self.canary_costs = []


class DriftMonitor:
    """Watches live costs, demotes drifted finals, canaries challengers.

    ``background`` (optional) runs re-tunes off the hot path; without it the
    re-tune runs synchronously inside :meth:`observe` (deterministic — the
    test/bench mode).  ``on_apply(state)`` fires after every selection the
    monitor makes (canary start and rollback) so callers mirroring
    selections elsewhere — the Server's DegreeController — stay in sync.
    """

    def __init__(
        self,
        background: Optional[Any] = None,  # BackgroundTuner (duck-typed)
        factor: float = 2.0,
        alpha: float = 0.25,
        min_observations: int = 4,
        canary_window: int = 4,
        canary_margin: float = 1.0,
        on_apply: Optional[Callable[[OpState], None]] = None,
    ) -> None:
        if factor <= 1.0:
            raise ValueError(f"drift factor must be > 1, got {factor}")
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"EWMA alpha must be in (0, 1], got {alpha}")
        self.background = background
        self.factor = factor
        self.alpha = alpha
        self.min_observations = max(1, min_observations)
        self.canary_window = max(1, canary_window)
        self.canary_margin = canary_margin
        self.on_apply = on_apply
        self.transitions: List[tuple] = []  # (fingerprint, kind) in order
        # observations held against a live final's recorded cost: what a
        # count of 0 transitions on a healthy run is worth (in all, and by
        # class fingerprint)
        self.checks = 0
        self.class_checks: Dict[str, int] = {}
        self._watches: Dict[str, _Watch] = {}
        self._lock = threading.Lock()

    # -- the run-time-layer feed ----------------------------------------------

    def observe(
        self,
        op: AutotunedOp,
        state: OpState,
        measured_cost: float,
        args: tuple = (),
        kwargs: Optional[dict] = None,
    ) -> Optional[str]:
        """Feed one measured cost for ``state``'s live selection.

        ``args``/``kwargs`` are the call's (example) arguments — captured at
        demotion time so the re-tune can measure candidates on real inputs.
        Returns the transition this observation triggered (``"demoted"``,
        ``"promoted"``, ``"rolled_back"``) or ``None``.
        """
        kwargs = kwargs or {}
        fp = state.bp.fingerprint()
        with self._lock:
            watch = self._watches.setdefault(fp, _Watch())
            if watch.phase == "canary":
                watch.canary_costs.append(float(measured_cost))
                if len(watch.canary_costs) < self.canary_window:
                    return None
                return self._verdict(op, state, watch)
            watch.ewma = (
                float(measured_cost) if watch.ewma is None
                else self.alpha * float(measured_cost)
                + (1.0 - self.alpha) * watch.ewma
            )
            watch.n += 1
            if watch.phase != "healthy":
                return None  # re-tune already in flight
            recorded = self._recorded_final_cost(op, state)
            if recorded is None or watch.n < self.min_observations:
                return None
            self.checks += 1
            self.class_checks[fp] = self.class_checks.get(fp, 0) + 1
            if watch.ewma <= self.factor * recorded:
                return None
            return self._demote(op, state, watch, recorded, args, kwargs)

    def watch_phase(self, state: OpState) -> str:
        with self._lock:
            watch = self._watches.get(state.bp.fingerprint())
            return watch.phase if watch else "healthy"

    def request_retune(
        self,
        op: AutotunedOp,
        state: OpState,
        args: tuple = (),
        kwargs: Optional[dict] = None,
        reason: str = "fleet",
    ) -> bool:
        """An externally requested demote → re-tune → canary.

        The anti-entropy sync loop calls this when the global tuning
        service reports a fleet-wide re-tune request for a class this host
        is live-serving: drift observed by *one* host re-tunes every host.
        Unlike :meth:`observe` it does not wait for local evidence — the
        service's word is the trigger — but the challenger still earns its
        promotion through the normal canary window against this host's own
        observations.  Returns False when the class is already mid-
        lifecycle or has no recorded best to re-tune (the DB-side demotion
        has already landed via merge in that case).
        """
        kwargs = kwargs or {}
        with self._lock:
            watch = self._watches.setdefault(state.bp.fingerprint(), _Watch())
            if watch.phase != "healthy":
                return False
            recorded = op.db.best_cost(state.bp)
            if recorded is None:
                return False
            if watch.ewma is None:
                # no local observations yet: the recorded cost stands in as
                # what the incumbent was delivering, so the canary verdict
                # still has a bar to clear
                watch.ewma = float(recorded)
            self._demote(op, state, watch, float(recorded), args, kwargs,
                         reason=reason)
            return True

    # -- transitions -----------------------------------------------------------

    @staticmethod
    def _recorded_final_cost(op: AutotunedOp, state: OpState) -> Optional[float]:
        """The recorded cost of this class's *final* best, if one is live."""
        sig = getattr(state.region, "space_signature", None)
        if op.db.tuned_point(state.bp, space_signature=sig) is None:
            return None
        return op.db.best_cost(state.bp)

    def _demote(
        self,
        op: AutotunedOp,
        state: OpState,
        watch: _Watch,
        recorded: float,
        args: tuple,
        kwargs: dict,
        reason: str = "drift",
    ) -> str:
        """Caller holds the lock."""
        op.db.demote_best(state.bp)
        watch.incumbent = dict(state.region.selected)
        watch.incumbent_observed = float(watch.ewma)
        watch.phase = "retuning"
        self._log(op, state, "demoted",
                  observed=float(watch.ewma), recorded=float(recorded),
                  factor=self.factor, reason=reason,
                  point=dict(state.region.selected))
        mode = "background" if self.background is not None else "inline"
        self._log(op, state, "retune_scheduled", mode=mode)
        if self.background is not None:
            queued = self.background.submit_retune(
                op, state, args, kwargs,
                on_winner=lambda winner: self._on_challenger(op, state, winner),
            )
            if not queued:
                # the class is already queued/tuning on the worker (another
                # monitor or server racing on the same DB): no on_winner
                # will ever reach us, so re-arm instead of waiting forever —
                # the racer's verdict re-finalizes the entry and this watch
                # resumes supervising it
                self._log(op, state, "retune_failed", reason="already_inflight")
                watch.reset()
        else:
            # deterministic mode: re-tune right here (tests, benches).  The
            # lock is held — fine, the inline path is single-threaded.
            try:
                winner = op.retune_state(state, args, kwargs)
            except Exception:
                winner = None
            self._challenger_locked(op, state, winner)
        return "demoted"

    def _on_challenger(
        self, op: AutotunedOp, state: OpState, winner: Optional[Dict[str, Any]]
    ) -> None:
        """Background re-tune completion (worker thread)."""
        with self._lock:
            self._challenger_locked(op, state, winner)

    def _challenger_locked(
        self, op: AutotunedOp, state: OpState, winner: Optional[Dict[str, Any]]
    ) -> None:
        watch = self._watches.setdefault(state.bp.fingerprint(), _Watch())
        if winner is None:
            self._log(op, state, "retune_failed")
            watch.reset()
            return
        watch.challenger = dict(winner)
        watch.canary_costs = []
        watch.phase = "canary"
        # provisional hot apply: the canary window *runs* the challenger,
        # but nothing is recorded final until the verdict
        state.region.select(winner)
        self._log(op, state, "canary_start",
                  challenger=dict(winner), incumbent=watch.incumbent,
                  incumbent_observed=watch.incumbent_observed,
                  window=self.canary_window)
        self._apply(state)

    def _verdict(self, op: AutotunedOp, state: OpState, watch: _Watch) -> str:
        """Caller holds the lock; the canary window just filled."""
        costs = sorted(watch.canary_costs)
        challenger_observed = costs[len(costs) // 2]
        beats = challenger_observed < watch.incumbent_observed * self.canary_margin
        if beats:
            op.db.record_best(
                state.bp, watch.challenger, challenger_observed, "run_time"
            )
            self._log(op, state, "promoted",
                      challenger=dict(watch.challenger),
                      observed=float(challenger_observed),
                      incumbent_observed=float(watch.incumbent_observed))
            outcome = "promoted"
        else:
            state.region.select(watch.incumbent)
            # re-finalize the incumbent at what it actually delivers, so the
            # recorded expectation matches reality and the watch re-arms
            # instead of re-tripping on the very next observation
            op.db.record_best(
                state.bp, watch.incumbent, watch.incumbent_observed, "run_time"
            )
            self._log(op, state, "rolled_back",
                      challenger=dict(watch.challenger),
                      observed=float(challenger_observed),
                      incumbent=dict(watch.incumbent),
                      incumbent_observed=float(watch.incumbent_observed))
            self._apply(state)
            outcome = "rolled_back"
        watch.reset()
        return outcome

    # -- internals -------------------------------------------------------------

    def _log(self, op: AutotunedOp, state: OpState, kind: str, **payload) -> None:
        self.transitions.append((state.bp.fingerprint(), kind))
        op.db.record_event(state.bp, kind, **payload)

    def _apply(self, state: OpState) -> None:
        if self.on_apply is not None:
            try:
                self.on_apply(state)
            except Exception:
                pass  # a mirror-bookkeeping bug must not kill the watch
