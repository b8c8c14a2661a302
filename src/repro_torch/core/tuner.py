"""The FIBER three-layer tuner (paper §II.A, §IV.A).

Layer semantics:

* **install** — BP-independent sweeps done once per build (kernel block
  shapes on reference shapes).  Results seed later layers.
* **before_execution** — the user has fixed BP (problem size, mesh, max
  degree).  The tuner searches the PP space with the given cost function and
  records the argmin.  This is where the paper measures all candidates
  ("Perform AT for changing the number of threads for all candidates...").
* **run_time** — the selected candidate is used for real work; measured step
  times are appended to the DB.  If the selected candidate regresses
  (straggler, interference), :meth:`RuntimeSelector.observe` re-selects the
  next-best *precompiled* candidate — switching is free because every
  candidate was AOT-compiled (paper §IV.D: "we can change the number of
  threads frequently at run-time").
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Mapping, Optional

from ..obs.trace import current_tracer
from .db import TuningDB
from .params import BasicParams, ParamSpace, pp_key
from .region import ATRegion
from .search import ExhaustiveSearch, Search, SearchResult, Trial

LAYERS = ("install", "before_execution", "run_time")


class Tuner:
    def __init__(self, db: Optional[TuningDB] = None, search: Optional[Search] = None):
        self.db = db or TuningDB()
        self.search = search or ExhaustiveSearch()

    def tune(
        self,
        region: ATRegion,
        bp: BasicParams,
        cost: Callable[[Mapping[str, Any]], float],
        layer: str = "before_execution",
        select: bool = True,
        search: Optional[Search] = None,
        fresh: bool = False,
        finalize: bool = True,
    ) -> SearchResult:
        """AT = argmin_PP cost(PP | BP).  Records every trial in the DB.

        ``search`` overrides the tuner's strategy for this one problem —
        the staged pipeline builds a per-shape-class search (warm-start
        seed, prescreen over this class's example args) that cannot be
        pinned at construction time.

        ``fresh=True`` disables the recorded-trial short-circuit: every
        point is re-measured (still recorded).  This is the drift re-tune
        path (docs/fleet.md) — the recorded costs are exactly what the
        runtime has drifted away from, so replaying them would just
        reconfirm the demoted winner.  ``finalize=False`` skips the final
        ``record_best`` (the re-tune's challenger is only finalized after
        it survives its canary window).
        """
        if layer not in LAYERS:
            raise ValueError(f"unknown FIBER layer {layer!r}; expected one of {LAYERS}")

        supports_budget = bool(getattr(cost, "supports_budget", False))

        def quarantine(point: Mapping[str, Any], reason: str) -> None:
            tr = current_tracer()
            if tr is not None:
                tr.instant(
                    "tuner.quarantine", cat="tuner", region=region.name,
                    layer=layer, pp=pp_key(point), reason=reason,
                )
            self.db.record_quarantine(bp, point, reason, layer=layer)

        def measured(point: Mapping[str, Any], fn: Callable[[], float]) -> float:
            """Measurement guardrail: a candidate whose cost raises or comes
            back non-finite (NaN/inf) is *quarantined* in the DB — it can
            never win this search (cost becomes +inf) nor any later one
            (merge propagates the marker fleet-wide) — instead of a NaN
            silently surviving argmin comparisons or one broken candidate
            aborting the whole sweep.  Control-flow exceptions (trial-budget
            exhaustion marks itself ``tuning_control``) still propagate."""
            try:
                c = float(fn())
            except Exception as exc:
                if getattr(exc, "tuning_control", False):
                    raise
                quarantine(point, f"cost raised {type(exc).__name__}: {exc}")
                return math.inf
            if not math.isfinite(c):
                quarantine(point, f"non-finite cost {c!r}")
                return math.inf
            return c

        def guarded(point: Mapping[str, Any], fn: Callable[[], float]) -> float:
            tr = current_tracer()
            if tr is None:
                return measured(point, fn)
            with tr.span(
                "tuner.trial", cat="tuner", region=region.name, layer=layer,
                pp=pp_key(point),
            ) as attrs:
                c = measured(point, fn)
                attrs["cost"] = c
                attrs["verdict"] = "ok" if math.isfinite(c) else "quarantined"
                return c

        def caching_cost(
            point: Mapping[str, Any], budget: Optional[int] = None
        ) -> float:
            if self.db.is_quarantined(bp, point):
                return math.inf  # known-broken: never re-measure, never wins
            if budget is not None and supports_budget:
                # budget-aware re-measurement (SuccessiveHalving rungs): a
                # higher budget buys a *better* estimate, so the cached
                # trial must not short-circuit it; the DB keeps the latest
                # (highest-budget) estimate for resume.
                c = guarded(point, lambda: cost(point, budget))
                if math.isfinite(c):
                    self.db.record_trial(bp, point, c, layer)
                return c
            prior = None if fresh else self.db.trial_cost(bp, point)
            if prior is not None:
                return prior  # resume support: interrupted AT re-uses trials
            c = guarded(point, lambda: cost(point))
            if math.isfinite(c):
                self.db.record_trial(bp, point, c, layer)
            return c

        # budgeted searches probe this to decide whether budgets pass through
        caching_cost.supports_budget = supports_budget

        tr = current_tracer()
        if tr is None:
            result = (search or self.search).run(region.space, caching_cost)
        else:
            with tr.span(
                "tuner.tune", cat="tuner", region=region.name, layer=layer,
                fingerprint=bp.fingerprint(),
            ) as attrs:
                result = (search or self.search).run(region.space, caching_cost)
                attrs["evaluations"] = result.evaluations
                attrs["best_pp"] = pp_key(result.best.point)
                attrs["best_cost"] = result.best.cost
        if not math.isfinite(result.best.cost):
            # every candidate raised or returned NaN/inf: there is no sane
            # winner to select or finalize — fail the search loudly (the
            # BackgroundTuner records it as a failed job; the live path
            # keeps serving on the region's default selection)
            raise RuntimeError(
                f"tuning failed for {region.name}: every candidate "
                "quarantined (raising or non-finite cost)"
            )
        if finalize:
            self.db.record_best(
                bp, result.best.point, result.best.cost, layer,
                space_signature=getattr(region, "space_signature", None),
            )
        if select:
            region.select(result.best.point)
        return result


class RuntimeSelector:
    """FIBER run-time layer: monitor the live candidate, re-select if it regresses.

    This doubles as our straggler-mitigation hook: a candidate whose measured
    cost drifts ``tolerance``× above its tuned cost (e.g. a slow host, noisy
    neighbour, thermal throttle) is demoted and the next-best precompiled
    candidate takes over — no recompilation, mirroring the paper's free
    ``omp_set_num_threads`` switches.
    """

    def __init__(
        self,
        region: ATRegion,
        bp: BasicParams,
        db: TuningDB,
        tolerance: float = 1.5,
        window: int = 8,
    ) -> None:
        self.region = region
        self.bp = bp
        self.db = db
        self.tolerance = tolerance
        self.window = window
        self._recent: list = []
        ranked = sorted(db.trials(bp).items(), key=lambda kv: kv[1])
        self._ranking = [k for k, _ in ranked]
        self.switches = 0

    def observe(self, measured_cost: float) -> bool:
        """Record a live measurement; returns True if a re-selection happened."""
        self.db.record_runtime_observation(self.bp, self.region.selected, measured_cost)
        self._recent.append(measured_cost)
        if len(self._recent) > self.window:
            self._recent.pop(0)
        tuned = self.db.trial_cost(self.bp, self.region.selected)
        if tuned is None or len(self._recent) < self.window:
            return False
        median = sorted(self._recent)[len(self._recent) // 2]
        if median <= self.tolerance * tuned:
            return False
        # Demote: pick the best-ranked *precompiled* candidate that is not the
        # current one (switching must stay free — no compilation at run time).
        # If nothing is precompiled (plain regions), any ranked candidate will do.
        import json

        current = pp_key(self.region.selected)
        others = [k for k in self._ranking if k != current]
        pool = [k for k in others if self.region.is_compiled_key(k)] or others
        if pool:
            self.region.select(json.loads(pool[0]))
            self._recent.clear()
            self.switches += 1
            return True
        return False
