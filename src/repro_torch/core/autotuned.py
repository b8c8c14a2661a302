"""AutotunedOp — registry-backed dispatch for one tunable op.

The life of a call ``autotuned("flash_attention")(q, k, v)``:

1. **shape class** — ``spec.shape_class(*args)`` buckets the call into a
   :class:`~repro_torch.core.params.BasicParams` (the DB key).
2. **lookup** — an in-process state cache, then the TuningDB.  Either hit
   means *zero* cost-function evaluations (the acceptance bar: a second call
   for the same shape class never re-tunes, even in a fresh process reading
   the same DB file).
3. **tune on miss** — the configured :class:`~repro_torch.core.search.Search`
   under ``trial_budget`` evaluations; every trial lands in the DB, so an
   interrupted sweep resumes where it stopped.  With no pinned search the
   op builds a per-shape-class staged pipeline (docs/tuning.md): a
   **cross-shape-class warm start** (the nearest already-tuned sibling
   class seeds the search) when the DB has one, a **hint prescreen →
   measured finals** :class:`~repro_torch.core.search.StagedSearch` when the
   spec provides a ``prescreen_factory`` (or ``staged=True`` forces the
   emit-hint prescreen), and plain exhaustive measured search otherwise.
4. **top-k warm** — the k best candidates are materialized through
   ``region.candidate`` and launched once, so run-time switching is a dict
   lookup — ppOpen-AT's free ``omp_set_num_threads`` switch, generalized.
5. **run-time layer** — a :class:`~repro_torch.core.tuner.RuntimeSelector` watches
   measured call times and demotes a regressing candidate to the next-best
   *precompiled* one; a :class:`~repro_torch.fleet.DriftMonitor`
   (``drift=``) watches the same trickle against the recorded final.

``device_key=True`` (or ``REPRO_DEVICE_KEY=1``) extends every shape class
with the :class:`~repro_torch.fleet.DeviceFingerprint` of the call's
tensors' device, so a fleet-shared DB recalls a final only on the device
that measured it.
"""
from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional

import torch

from ..obs.trace import current_tracer
from .cost import (
    AdaptiveWallClockCost, _block, _leaves, l2_flush, sampled_call, timing_lock,
)
from .db import TuningDB
from .emit import hint_prescreen
from .params import BasicParams, pp_key, project_point
from .region import ATRegion
from .registry import KernelSpec
from .search import CoordinateDescent, Search, StagedSearch, default_prescreen_k
from .traffic import TrafficClass
from .tuner import RuntimeSelector, Tuner


class TrialBudgetExhausted(Exception):
    """Raised internally when a search hits its evaluation budget."""

    # marks this as tuner control flow: the measurement guardrail in
    # Tuner.tune must re-raise it, not quarantine the candidate it
    # happened to interrupt
    tuning_control = True


# Upper bound on fast-dispatch routes per op.  Structural keys include
# hashable scalar argument *values*, so an op called with an unbounded
# stream of distinct scalars (a step counter, say) would otherwise leak one
# entry per value; past the limit new keys simply stay on the slow path
# (correct, just not collapsed), while the bounded _states cache still
# dedupes by shape class.
FAST_TABLE_LIMIT = 512


class _FastEntry:
    """One finalized dispatch route: structural arg key -> bound callable.

    ``version`` mirrors the region's selection version at bind time; a
    RuntimeSelector demotion or joint-program hot apply bumps the region's
    version, and the next fast call rebinds with one dict lookup — the
    finalized class never re-enters the slow path (no BP extraction, no
    lock, no selector walk).
    """

    __slots__ = ("fn", "state", "region", "version", "calls")

    def __init__(self, fn: Callable[..., Any], state: "OpState", version: int) -> None:
        self.fn = fn
        self.state = state
        self.region = state.region
        self.version = version
        self.calls = 0


def _arg_sig(a: Any) -> Any:
    """Cheap structural signature of one call argument (shape-class safe).

    Tensors key on (shape, dtype, device) — a CPU call and a CUDA call of
    one shape must not share a route; containers recurse; hashable scalars
    key on value.  Raises TypeError for anything else — the caller falls
    back to the slow path rather than guessing.
    """
    try:
        return (a.shape, a.dtype, a.device)  # the hot case: tensors
    except AttributeError:
        pass
    if isinstance(a, (int, float, str, bool, bytes)) or a is None:
        return a
    if isinstance(a, dict):
        return tuple(sorted((k, _arg_sig(v)) for k, v in a.items()))
    if isinstance(a, (list, tuple)):
        return tuple(map(_arg_sig, a))
    raise TypeError(f"unkeyable dispatch argument: {type(a)!r}")


def _fast_key(args: tuple, kwargs: dict) -> Optional[tuple]:
    """Structural dispatch key, or ``None`` when args cannot be keyed."""
    try:
        if kwargs:
            return (
                tuple(map(_arg_sig, args)),
                tuple(sorted((k, _arg_sig(v)) for k, v in kwargs.items())),
            )
        return tuple(map(_arg_sig, args))
    except TypeError:
        return None


@dataclass
class OpState:
    """Everything the op holds for one shape class."""

    bp: BasicParams
    region: ATRegion
    selector: Optional[RuntimeSelector] = None
    tuned: bool = False           # did *this process* run cost evaluations?
    from_cache: bool = False      # selection came from the DB, zero evals
    cost_evaluations: int = 0     # measured (stage-2) evaluations only
    prescreen_evaluations: int = 0  # cheap stage-1 scores (never measured)
    warm_seed: Optional[Dict[str, Any]] = None  # cross-class warm-start seed
    warmed: int = 0
    traffic: Optional[TrafficClass] = None  # set when the spec buckets traffic
    tune_thread: Optional[int] = None       # ident of the thread that tuned


class AutotunedOp:
    """Callable dispatcher for one registered kernel.

    ``monitor=True`` (default) blocks on the output of every
    ``monitor_every``-th call and feeds its measured wall time to the
    RuntimeSelector; latency-critical callers that do their own timing (the
    train loop) pass ``monitor=False`` and call ``state.selector.observe``
    themselves.  ``drift`` (a DriftMonitor, settable later) gets the same
    calls, timed on the yardstick the recorded final was measured on: on
    CUDA tensors :func:`~repro_torch.core.cost.sampled_call` (event time
    after the trials' spin), whose time the selector then takes too (the
    host clock for CPU tensors, and without ``drift``).  A CUDA sample
    whose host enqueue outlasted the spin feeds neither and counts in
    ``host_bound_samples``.
    """

    def __init__(
        self,
        spec: KernelSpec,
        registry=None,
        db: Optional[TuningDB] = None,
        search: Optional[Search] = None,
        top_k: int = 2,
        trial_budget: Optional[int] = None,
        warm: bool = True,
        tune: bool = True,
        monitor: bool = True,
        tolerance: float = 1.5,
        window: int = 8,
        cost_factory: Optional[Callable[..., Callable[[Mapping[str, Any]], float]]] = None,
        staged: Optional[bool] = None,
        prescreen_k: Optional[int] = None,
        warm_start: bool = True,
        fast_dispatch: bool = True,
        monitor_every: int = 64,
        device_key: Optional[bool] = None,
        drift: Optional[Any] = None,
    ) -> None:
        self.spec = spec
        self._registry = registry
        self._db = db
        self.search = search
        self.top_k = top_k
        self.trial_budget = trial_budget
        self.warm = warm
        self.tune = tune
        self.monitor = monitor
        self.tolerance = tolerance
        self.window = window
        self.cost_factory = cost_factory or spec.cost_factory
        # staged-pipeline policy (only consulted when no ``search`` is
        # pinned): None = staged iff the spec has a prescreen_factory,
        # True = force the emit-hint prescreen, False = never stage.
        self.staged = staged
        self.prescreen_k = prescreen_k
        self.warm_start = warm_start
        # zero-overhead dispatch (docs/program.md): once a shape class is
        # *final* (completed search in the DB), calls collapse to one dict
        # lookup on a structural key — no BP extraction, no fingerprint
        # hash, no lock.  Value-dependent class extraction (traffic-class
        # specs bucket on runtime scalars) cannot be keyed structurally, so
        # those ops stay on the slow path.
        self.fast_dispatch = fast_dispatch and spec.traffic_class is None
        self.monitor_every = max(1, monitor_every)
        # fleet device keying: opt-in per op (None defers to
        # REPRO_DEVICE_KEY); flipping it changes every BP fingerprint, i.e.
        # starts a fresh device-scoped namespace in an existing DB
        if device_key is None:
            device_key = os.environ.get("REPRO_DEVICE_KEY", "").lower() in ("1", "true", "yes")
        self.device_key = bool(device_key)
        # drift watch: a DriftMonitor fed by the same run-time trickle the
        # RuntimeSelector gets; settable later (op.drift = monitor)
        self.drift = drift
        self._fast: Dict[tuple, _FastEntry] = {}
        self.slow_resolutions = 0  # full shape-class resolutions performed
        self.host_bound_samples = 0  # CUDA samples dropped: enqueue outlasted the spin
        self._states: Dict[str, OpState] = {}
        self._state_lock = threading.Lock()  # guards the two dicts below
        self._build_locks: Dict[str, threading.Lock] = {}

    # -- public --------------------------------------------------------------

    @property
    def db(self) -> TuningDB:
        if self._db is None:
            if self._registry is None:
                self._db = TuningDB()
            else:
                self._db = self._registry.default_db()
        return self._db

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        if self._fast:
            entry = self._fast_lookup(args, kwargs)
            if entry is not None:
                entry.calls += 1
                if self.monitor and entry.calls % self.monitor_every == 0:
                    # a trickle of run-time-layer observations keeps the
                    # straggler watch alive without per-call timing; still
                    # no BP extraction, no lock, no re-resolution
                    return self._monitored(entry.state, args, kwargs)
                return entry.fn(*args, **kwargs)
        state = self.resolve(*args, **kwargs)
        self._maybe_install_fast(state, args, kwargs)
        if not self.monitor or state.selector is None:
            return state.region(*args, **kwargs)
        return self._monitored(state, args, kwargs)

    def dispatch(self, *args: Any, **kwargs: Any) -> Callable[..., Any]:
        """The callable this call would execute — dispatch decision only.

        On the fast path this is a single dict lookup; otherwise a full
        resolution (tuning on a miss, like ``__call__``).  The dispatch
        microbenchmark times exactly this.
        """
        if self._fast:
            entry = self._fast_lookup(args, kwargs)
            if entry is not None:
                return entry.fn
        state = self.resolve(*args, **kwargs)
        self._maybe_install_fast(state, args, kwargs)
        return state.region.candidate(state.region.selected)

    def finalize(self, state: OpState, *args: Any, **kwargs: Any) -> bool:
        """Install the fast dispatch route for ``state`` and these args.

        Used by callers that pin or hot-apply a selection outside a
        completed per-kernel search (joint program winners): the class is
        final *by decree*, so dispatch may collapse even though the op's
        own DB entry never finished a search.
        """
        if not self.fast_dispatch:
            return False
        key = _fast_key(args, kwargs)
        if key is None:
            return False
        region = state.region
        version = region.version  # pre-read: same stale-pin guard as
        # _fast_lookup — a concurrent select() just forces one extra rebind
        entry = _FastEntry(region.candidate(region.selected), state, version)
        with self._state_lock:
            if key not in self._fast and len(self._fast) >= FAST_TABLE_LIMIT:
                return False  # bounded: overflow keys keep the slow path
            self._fast[key] = entry
        return True

    def _monitored(self, state: OpState, args: tuple, kwargs: dict) -> Any:
        if state.selector is None:
            return state.region(*args, **kwargs)
        device = call_device(args, kwargs) if self.drift is not None else None
        if device is not None and device.type == "cuda":
            # the drift watch holds the sample to the recorded final's
            # yardstick: device time from CUDA events after the trials'
            # spin (a host time would carry the wrapper's Python, the
            # launch and the synchronise), in a timed window of its own on
            # the card.  A trial timing there now would read into the
            # sample, and waiting for it would hold up the hot path: the
            # call then runs unsampled.  So does a call whose enqueue
            # outlasted the spin (its events may hold host time).
            lock = timing_lock(device)
            if not lock.acquire(blocking=False):
                return state.region(*args, **kwargs)
            try:
                out, cost = sampled_call(lambda: state.region(*args, **kwargs), device)
            finally:
                lock.release()
            if cost is None:
                self.host_bound_samples += 1
                return out
            # the selector's trial costs are event times too: it takes the
            # same sample
            state.selector.observe(cost)
        else:
            t0 = time.perf_counter()
            out = state.region(*args, **kwargs)
            _block(out)
            cost = time.perf_counter() - t0
            state.selector.observe(cost)
        if self.drift is not None:
            self.drift.observe(self, state, cost, args, kwargs)
        return out

    def _fast_lookup(self, args: tuple, kwargs: dict) -> Optional[_FastEntry]:
        # flat on purpose: this is the measured per-call overhead, so the
        # key is built inline (no helper-call tower) and misses bail early
        try:
            if kwargs:
                key = (
                    tuple(map(_arg_sig, args)),
                    tuple(sorted((k, _arg_sig(v)) for k, v in kwargs.items())),
                )
            else:
                key = tuple(map(_arg_sig, args))
        except TypeError:
            return None
        entry = self._fast.get(key)
        if entry is None:
            return None
        region = entry.region
        version = region.version  # read BEFORE building the callable: if a
        # concurrent select() lands in between, we store the older version
        # and the next call rebinds again — never the reverse (a stale
        # callable pinned under a newer version would stick forever)
        if entry.version != version:
            # selection moved (demotion / joint hot apply): rebind, still
            # without touching the slow path
            entry.fn = region.candidate(region.selected)
            entry.version = version
        return entry

    def _maybe_install_fast(self, state: OpState, args: tuple, kwargs: dict) -> None:
        """Collapse future dispatches once this shape class is final."""
        if not self.fast_dispatch:
            return
        if not (state.from_cache or state.tuned):
            return
        sig = getattr(state.region, "space_signature", None)
        if self.db.tuned_point(state.bp, space_signature=sig) is None:
            return  # interim winner (budget-capped sweep): not final yet
        self.finalize(state, *args, **kwargs)

    def resolve(self, *args: Any, **kwargs: Any) -> OpState:
        """The op's state for this call's shape class, tuning if needed."""
        return self._resolve(args, kwargs, self.tune)

    def resolve_deferred(self, *args: Any, **kwargs: Any) -> OpState:
        """Resolve without ever tuning on the calling thread.

        The background-tuner entry: a DB hit still selects the tuned winner,
        a miss returns the safe default for someone else to tune later.
        Unlike toggling ``self.tune`` around ``resolve``, this is safe under
        concurrent callers.
        """
        return self._resolve(args, kwargs, False)

    def _resolve(self, args: tuple, kwargs: dict, tune: bool) -> OpState:
        self.slow_resolutions += 1
        bp = self.spec.shape_class(*args, **kwargs)
        traffic = None
        if self.spec.traffic_class is not None:
            traffic = self.spec.traffic_class(*args, **kwargs)
            bp = bp.with_entries(**traffic.bp_entries())
        if self.device_key:
            from ..fleet.fingerprint import device_bp_entries

            bp = bp.with_entries(**device_bp_entries(call_device(args, kwargs)))
        fp = bp.fingerprint()
        # one canonical state per shape class even under concurrent callers:
        # a losing racer must not build (and possibly tune) a duplicate that
        # the background tuner would then hot-swap into the void.  The build
        # runs under a per-fingerprint lock so an inline tune of one class
        # never blocks resolution of another.
        with self._state_lock:
            state = self._states.get(fp)
            if state is not None:
                return state
            build_lock = self._build_locks.setdefault(fp, threading.Lock())
        with build_lock:
            with self._state_lock:
                state = self._states.get(fp)
            if state is not None:
                return state
            # tracer guard lives HERE, on the slow path only: the fast
            # dispatch route in __call__/_fast_lookup carries zero tracer
            # code (the bench_dispatch >=10x and obs_overhead <=2% gates)
            tr = current_tracer()
            if tr is None:
                state = self._build_state(bp, args, kwargs, tune)
            else:
                with tr.span(
                    "dispatch.resolve", cat="dispatch", op=self.spec.name,
                    fingerprint=fp,
                ) as attrs:
                    state = self._build_state(bp, args, kwargs, tune)
                    attrs["from_cache"] = state.from_cache
                    attrs["tuned"] = state.tuned
            state.traffic = traffic
            with self._state_lock:
                self._states[fp] = state
            return state

    def select(self, point: Mapping[str, Any], *args: Any, **kwargs: Any) -> OpState:
        """Pin a PP point for this shape class (bypasses tuning)."""
        state = self.resolve_deferred(*args, **kwargs)
        state.region.select(point)
        return state

    def states(self) -> Dict[str, OpState]:
        return dict(self._states)

    def retune_state(
        self, state: OpState, args: tuple, kwargs: dict
    ) -> Dict[str, Any]:
        """Fresh re-measure of an already-tuned class (the drift path).

        Unlike :meth:`tune_state` this runs even when ``state.tuned`` /
        ``from_cache`` — that is the point: the recorded winner drifted.
        The search re-measures every candidate (``fresh``: the recorded
        trial costs are what reality walked away from), does NOT select the
        winner (the caller canaries it first), does NOT record a final (the
        challenger earns that by surviving its canary window), and warms
        the challenger so the canary hot swap never builds.
        """
        winner = self._tune(state, args, kwargs, select=False, fresh=True,
                            finalize=False)
        fn = state.region.candidate(winner)
        if (args or kwargs) and dict(winner) != dict(state.region.selected):
            _block(fn(*args, **kwargs))
        return winner

    def tune_state(
        self,
        state: OpState,
        args: tuple,
        kwargs: dict,
        search: Optional[Search] = None,
    ) -> OpState:
        """Run deferred tuning for an already-resolved state.

        This is the background-tuner entry point: ``resolve_deferred`` hands
        out a state serving the region's safe default, and a worker thread
        later calls this to search, warm the top-k, and hot-swap the
        region's selection — the serve hot path never pays a cost
        evaluation.  Ordering matters: the search runs with ``select=False``
        so the hot path keeps serving the (already compiled) default while
        we warm — selecting the winner before it is compiled would hand a
        concurrent request its trace/compile cost.  Only once the winner is
        warm does ``region.select`` swap it in.  Warming happens here
        regardless of ``self.warm`` (we are off the hot path by
        construction), and the selector is rebuilt because its ranking was
        computed before any trials existed.
        """
        if state.tuned or state.from_cache:
            return state
        winner = self._tune(state, args, kwargs, select=False, search=search)
        state.warmed = self._warm_topk(state, args, kwargs)
        if (args or kwargs) and dict(winner) == dict(state.region.selected):
            # winner == the live default: _warm_topk skipped executing it
            # ("about to run for real" — true inline, false here), so pay
            # any residual compile on this worker thread
            _block(state.region.candidate(winner)(*args, **kwargs))
        state.region.select(winner)  # the hot swap: winner is warm by now
        state.selector = RuntimeSelector(
            state.region, state.bp, self.db,
            tolerance=self.tolerance, window=self.window,
        )
        return state

    # -- internals -----------------------------------------------------------

    def _build_state(
        self, bp: BasicParams, args: tuple, kwargs: dict, tune: bool
    ) -> OpState:
        region = self.spec.make_region(bp)
        state = OpState(bp=bp, region=region)
        sig = getattr(region, "space_signature", None)
        if sig is not None:
            # emitted region: a final recorded under a different emission
            # (changed arch model / emit policy) is stale — demote it and
            # drop its trials so the search below starts clean
            self.db.invalidate_stale_final(bp, sig)
        tuned = self.db.tuned_point(bp, space_signature=sig)
        if tuned is not None:
            region.select(tuned)
            state.from_cache = True
        elif tune:
            self._tune(state, args, kwargs)
        if self.warm:
            state.warmed = self._warm_topk(state, args, kwargs)
        state.selector = RuntimeSelector(
            region, bp, self.db, tolerance=self.tolerance, window=self.window
        )
        return state

    def _tune(
        self,
        state: OpState,
        args: tuple,
        kwargs: dict,
        select: bool = True,
        fresh: bool = False,
        finalize: bool = True,
        search: Optional[Search] = None,
    ) -> Dict[str, Any]:
        """Search this state's PP space; returns the winning point.

        ``select=False`` leaves the region's live selection untouched (the
        background path swaps only after warming the winner).  ``fresh`` /
        ``finalize`` implement the drift re-tune (see :meth:`retune_state`);
        ``search`` overrides the strategy for this one run (the
        BackgroundTuner's fleet-sharded mode).
        """
        region, bp = state.region, state.bp
        search = search or self.search or self._default_search(state, args, kwargs)
        if self.cost_factory is not None:
            cost = self.cost_factory(region, bp, args, kwargs)
        else:
            cost = _wallclock_cost(region, args, kwargs)

        def budgeted(
            point: Mapping[str, Any], budget: Optional[int] = None
        ) -> float:
            if (
                self.trial_budget is not None
                and state.cost_evaluations >= self.trial_budget
            ):
                raise TrialBudgetExhausted(self.spec.name)
            state.cost_evaluations += 1
            if budget is not None and budgeted.supports_budget:
                return cost(point, budget)
            return cost(point)

        # let budget-aware searches (SuccessiveHalving rungs) pass their
        # repeat budget through to an AdaptiveWallClockCost-style cost
        budgeted.supports_budget = bool(getattr(cost, "supports_budget", False))

        tuner = Tuner(self.db)
        try:
            result = tuner.tune(region, bp, budgeted, select=select,
                                search=search, fresh=fresh, finalize=finalize)
            state.prescreen_evaluations += result.prescreen_evaluations
            winner = dict(result.best.point)
            self._record_search_event(state, result, winner)
        except TrialBudgetExhausted:
            # Budget hit mid-search: select the argmin over what we measured,
            # but do NOT record a DB best — only a completed search is final,
            # so the next run resumes from the recorded trials and keeps
            # exploring instead of treating the interim winner as tuned.
            trials = self.db.trials(bp)
            if not trials:
                raise ValueError(
                    f"{self.spec.name}: trial_budget={self.trial_budget} "
                    "allowed no evaluations"
                ) from None
            best_key = min(trials, key=trials.get)
            winner = json.loads(best_key)
            if select:
                region.select(winner)
        state.tuned = True
        state.tune_thread = threading.get_ident()
        return winner

    def _record_search_event(
        self, state: OpState, result: Any, winner: Mapping[str, Any]
    ) -> None:
        """Persist the decision audit of a completed search: the measured
        winner, how many candidates each stage touched, and the prescreen
        ranking that chose the finalists — what ``launch/observe.py
        explain`` later replays against the measured trial costs."""
        payload: Dict[str, Any] = {
            "winner": pp_key(winner),
            "cost": float(result.best.cost),
            "evaluations": result.evaluations,
            "prescreen_evaluations": result.prescreen_evaluations,
        }
        if result.prescreen_costs:
            ranked = sorted(
                result.prescreen_costs.items(), key=lambda kv: (kv[1], kv[0])
            )
            payload["prescreen_rank"] = [k for k, _ in ranked[:8]]
        sig = getattr(state.region, "space_signature", None)
        if sig is not None:
            payload["space_sig"] = str(sig)
        if state.warm_seed is not None:
            payload["warm_seed"] = pp_key(state.warm_seed)
        self.db.record_event(state.bp, "search_completed", **payload)

    def _default_search(
        self, state: OpState, args: tuple, kwargs: dict
    ) -> Optional[Search]:
        """The per-shape-class strategy when no search was pinned.

        Priority (docs/tuning.md): a staged prescreen → measured-finals
        pipeline when the op has a prescreen and the space is big enough to
        prune; a warm-started refinement when a sibling shape class is
        already tuned (seeding either the staged ranking or a
        CoordinateDescent hillclimb); ``None`` otherwise — the Tuner's
        exhaustive default, the paper's faithful strategy.
        """
        space = state.region.space
        seed = None
        if self.warm_start:
            near = self.db.nearest_tuned(state.bp)
            if near is not None:
                seed = project_point(space, near["point"])
                if seed is not None:
                    # warm-start provenance: which sibling class seeded this
                    # search and how far away it was (explainability trail)
                    self.db.record_event(
                        state.bp, "warm_start",
                        source_fp=near.get("fingerprint"),
                        distance=near["distance"], seed=dict(seed),
                    )
        prescreen = None
        if self.staged is not False:
            if self.spec.prescreen_factory is not None:
                prescreen = self.spec.prescreen_factory(
                    state.region, state.bp, args, kwargs
                )
            elif self.staged:
                prescreen = hint_prescreen(state.region, state.bp, args, kwargs)
        if prescreen is not None:
            n = sum(1 for _ in space.points())
            k = self.prescreen_k or default_prescreen_k(n)
            if n > k:  # otherwise nothing would be pruned: prescreen is waste
                if seed is not None:
                    state.warm_seed = dict(seed)
                return StagedSearch(prescreen, k=k, warm_start=seed)
        if seed is not None:
            state.warm_seed = dict(seed)
            return CoordinateDescent(start=seed)
        return None

    def _warm_topk(self, state: OpState, args: tuple, kwargs: dict) -> int:
        """Materialize the k best candidates so switching never compiles."""
        ranked = sorted(self.db.trials(state.bp).items(), key=lambda kv: kv[1])
        points: List[Dict[str, Any]] = [json.loads(k) for k, _ in ranked]
        if not points:  # untuned (pinned selection): warm the live point only
            points = [dict(state.region.selected)]
        warmed = 0
        for point in points[: max(1, self.top_k)]:
            fn = state.region.candidate(point)  # caches into region._compiled
            # the selected point is about to run for real — executing it here
            # too would double the first call's latency for nothing
            if (args or kwargs) and dict(point) != state.region.selected:
                _block(fn(*args, **kwargs))
            warmed += 1
        return warmed


def _wallclock_cost(
    region: ATRegion,
    args: tuple,
    kwargs: dict,
) -> Callable[[Mapping[str, Any]], float]:
    """Default measured cost: one untimed warm launch, then adaptive timed
    runs (docs/tuning.md) — the first steady-state run may end the point's
    measurement if it is already clearly off the incumbent; candidates
    within noise of the lead earn up to two more runs.

    On CUDA arguments each timed run is device time from CUDA events, and
    the L2 is flushed before it (twice the card's L2 is zeroed), so a
    candidate never profits from the inputs the previous run left cached.
    The flush and the timed run hold the device's :func:`timing_lock`, so
    two searches on one card (fleet workers) never time at once.
    """
    cuda = [t for t in _leaves((args, kwargs)) if t.is_cuda]
    prepare = lock = None
    if cuda:
        device = cuda[0].device
        l2 = torch.cuda.get_device_properties(device).L2_cache_size
        prepare = l2_flush(device, 2 * l2)
        lock = timing_lock(device)

    def build(point: Mapping[str, Any]) -> Callable[[], Any]:
        fn = region.instantiate(point)  # NOT region.candidate: only the
        # top-k winners should count as "precompiled" for the selector
        return lambda: fn(*args, **kwargs)

    return AdaptiveWallClockCost(
        build, warmup=1, min_repeats=1, max_repeats=3, prepare=prepare, lock=lock
    )


def call_device(args: tuple, kwargs: dict) -> Optional[torch.device]:
    """The device of a call's first tensor (``None`` without tensors)."""
    for t in _leaves((args, kwargs)):
        return t.device
    return None
