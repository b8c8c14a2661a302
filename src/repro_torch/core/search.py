"""Search strategies over a :class:`~repro_torch.core.params.ParamSpace`.

ppOpen-AT's before-execution layer enumerates every generated candidate (the
spaces are deliberately small — the paper limits candidate counts to avoid
code expansion).  We keep exhaustive search as the default and faithful
strategy, and add two cheaper strategies for the larger spaces our
distributed PPs create:

* :class:`ExhaustiveSearch` — measure every feasible point (the paper's).
* :class:`CoordinateDescent` — the hillclimb used by §Perf: sweep one
  parameter at a time, keep the argmin, repeat until a full pass moves
  nothing.  Exact for separable costs, good for near-separable ones.
* :class:`SuccessiveHalving` — measure all points with a cheap/noisy budget,
  keep the best half, re-measure with doubled budget, repeat.  Useful when
  cost evaluation itself is expensive (wall-clock with many repeats).
* :class:`StagedSearch` — the staged tuning pipeline (docs/tuning.md): a
  cheap *prescreen* cost scores the full space (independent candidates
  scored concurrently on a bounded pool), only
  the top-k survivors reach the *measured finals* search, and an optional
  warm-start seed from a neighbouring shape class is always kept alive.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

from ..obs.trace import current_tracer
from .params import ParamSpace, pp_key, project_point


@dataclass
class Trial:
    point: Dict[str, Any]
    cost: float


@dataclass
class SearchResult:
    best: Trial
    trials: List[Trial] = field(default_factory=list)
    evaluations: int = 0
    # staged pipeline bookkeeping: how many candidates the cheap prescreen
    # scored (zero for single-stage strategies) and what it scored them at.
    prescreen_evaluations: int = 0
    prescreen_costs: Dict[str, float] = field(default_factory=dict)

    def costs_by_key(self) -> Dict[str, float]:
        return {pp_key(t.point): t.cost for t in self.trials}


class Search:
    def run(self, space: ParamSpace, cost) -> SearchResult:  # pragma: no cover
        raise NotImplementedError


class ExhaustiveSearch(Search):
    """Measure every feasible PP point; return the argmin.

    ``on_trial`` (if given) is called after each evaluation — the tuner uses
    it for incremental DB writes so an interrupted AT run resumes where it
    stopped (fault tolerance applies to tuning too).
    """

    def __init__(self, on_trial: Optional[Callable[[Trial], None]] = None) -> None:
        self.on_trial = on_trial

    def run(self, space: ParamSpace, cost) -> SearchResult:
        trials: List[Trial] = []
        for point in space.points():
            t = Trial(dict(point), float(cost(point)))
            trials.append(t)
            if self.on_trial:
                self.on_trial(t)
        if not trials:
            raise ValueError("no feasible points to search")
        best = min(trials, key=lambda t: t.cost)
        return SearchResult(best=best, trials=trials, evaluations=len(trials))


class CoordinateDescent(Search):
    """Greedy one-parameter-at-a-time descent from ``start`` (or default)."""

    def __init__(
        self,
        start: Optional[Mapping[str, Any]] = None,
        max_passes: int = 8,
        on_trial: Optional[Callable[[Trial], None]] = None,
    ) -> None:
        self.start = dict(start) if start is not None else None
        self.max_passes = max_passes
        self.on_trial = on_trial

    def run(self, space: ParamSpace, cost) -> SearchResult:
        point = dict(self.start) if self.start is not None else space.default()
        space.validate(point)
        seen: Dict[str, float] = {}

        def eval_point(p: Dict[str, Any]) -> float:
            key = pp_key(p)
            if key not in seen:
                seen[key] = float(cost(p))
                trial = Trial(dict(p), seen[key])
                trials.append(trial)
                if self.on_trial:
                    self.on_trial(trial)
            return seen[key]

        trials: List[Trial] = []
        best_cost = eval_point(point)
        for _ in range(self.max_passes):
            moved = False
            for param in space.params:
                best_val = point[param.name]
                for candidate in param.domain:
                    if candidate == point[param.name]:
                        continue
                    trial_point = dict(point)
                    trial_point[param.name] = candidate
                    if not space.feasible(trial_point):
                        continue
                    c = eval_point(trial_point)
                    if c < best_cost:
                        best_cost, best_val, moved = c, candidate, True
                point[param.name] = best_val
            if not moved:
                break
        best = min(trials, key=lambda t: t.cost)
        return SearchResult(best=best, trials=trials, evaluations=len(trials))


class SuccessiveHalving(Search):
    """Rung-based elimination for expensive measured costs.

    ``cost`` must accept ``(point, budget)`` where budget is a positive int
    (e.g. number of timing repeats); wrap a plain cost with
    ``lambda p, b: cost(p)`` if budget-insensitive.

    ``on_trial`` (if given) is called after each evaluation — the same
    incremental-DB-write hook :class:`ExhaustiveSearch` and
    :class:`CoordinateDescent` have, so an interrupted measured-finals run
    resumes from its recorded trials instead of starting over
    (fault-tolerance parity across strategies).
    """

    needs_budget = True  # run() calls cost(point, budget), not cost(point)

    def __init__(
        self,
        initial_budget: int = 1,
        eta: int = 2,
        on_trial: Optional[Callable[[Trial], None]] = None,
    ) -> None:
        self.initial_budget = initial_budget
        self.eta = eta
        self.on_trial = on_trial

    def run(self, space: ParamSpace, cost) -> SearchResult:
        alive: List[Dict[str, Any]] = [dict(p) for p in space.points()]
        if not alive:
            raise ValueError("no feasible points to search")
        budget = self.initial_budget
        trials: List[Trial] = []
        evaluations = 0
        rung = 0
        while True:
            tr = current_tracer()
            if tr is None:
                scored = self._rung(alive, budget, cost, trials)
            else:
                with tr.span(
                    "search.rung", cat="search", rung=rung, budget=budget,
                    alive=len(alive),
                ) as attrs:
                    scored = self._rung(alive, budget, cost, trials)
                    attrs["best_cost"] = scored[0].cost
            evaluations += len(alive)
            if len(scored) == 1:
                return SearchResult(best=scored[0], trials=trials, evaluations=evaluations)
            keep = max(1, len(scored) // self.eta)
            alive = [t.point for t in scored[:keep]]
            budget *= self.eta
            rung += 1

    def _rung(
        self,
        alive: List[Dict[str, Any]],
        budget: int,
        cost,
        trials: List[Trial],
    ) -> List[Trial]:
        """Measure one elimination rung; returns the rung's trials sorted
        best-first (the caller keeps the top ``1/eta``)."""
        scored: List[Trial] = []
        for p in alive:
            t = Trial(dict(p), float(cost(p, budget)))
            scored.append(t)
            trials.append(t)
            if self.on_trial:
                self.on_trial(t)
        scored.sort(key=lambda t: t.cost)
        return scored


def default_prescreen_k(n_points: int) -> int:
    """How many prescreen survivors reach the measured-finals stage.

    ``ceil(sqrt(n))`` keeps the measured-evaluation count sublinear in the
    space size while leaving enough slack for prescreen ranking error — see
    docs/tuning.md for how to override it per op.
    """
    return max(2, math.isqrt(max(1, n_points - 1)) + 1)


class StagedSearch(Search):
    """Roofline prescreen → measured finals, with an optional warm-start seed.

    Stage 1 scores *every* feasible point with ``prescreen`` — an analytic
    cost (e.g. :func:`~repro_torch.core.emit.hint_prescreen`) that never
    executes a candidate.  Independent candidates are scored concurrently
    on a bounded :class:`ThreadPoolExecutor`.  A candidate whose prescreen raises is scored ``inf`` (it can
    still be reached by raising ``k`` — it is excluded, not failed).

    Stage 2 hands the ``k`` best-scoring survivors (plus ``warm_start``, if
    given — the seed is never pruned) to the ``finals`` search, which runs
    the *measured* ``cost`` the caller passed to :meth:`run`.  With
    ``k >= |space|`` every point survives and the result is exactly the
    exhaustive argmin of the measured cost.

    ``finals`` defaults to :class:`ExhaustiveSearch` over the survivors; a
    strategy with ``needs_budget`` (:class:`SuccessiveHalving`) gets the
    plain measured cost bridged to its ``(point, budget)`` signature unless
    the cost object itself advertises ``supports_budget``.
    """

    def __init__(
        self,
        prescreen: Callable[[Mapping[str, Any]], float],
        k: Optional[int] = None,
        finals: Optional[Search] = None,
        warm_start: Optional[Mapping[str, Any]] = None,
        max_workers: Optional[int] = None,
        on_trial: Optional[Callable[[Trial], None]] = None,
    ) -> None:
        self.prescreen = prescreen
        self.k = k
        self.finals = finals
        self.warm_start = dict(warm_start) if warm_start is not None else None
        self.max_workers = max_workers
        self.on_trial = on_trial

    def _score_all(
        self, points: List[Dict[str, Any]]
    ) -> Dict[str, float]:
        from .cost import score_points_concurrently

        batch = getattr(self.prescreen, "score_many", None)
        if batch is not None:  # e.g. CompiledRooflineCost: it owns the pool
            scores = batch(points, max_workers=self.max_workers)
        else:
            scores = score_points_concurrently(
                self.prescreen, points, self.max_workers
            )
        return {pp_key(p): s for p, s in zip(points, scores)}

    def run(self, space: ParamSpace, cost) -> SearchResult:
        points = [dict(p) for p in space.points()]
        if not points:
            raise ValueError("no feasible points to search")

        tr = current_tracer()
        if tr is None:
            scores = self._score_all(points)
        else:
            with tr.span(
                "search.prescreen", cat="search", candidates=len(points),
            ) as attrs:
                scores = self._score_all(points)
                finite = [s for s in scores.values() if math.isfinite(s)]
                attrs["scored"] = len(finite)
                attrs["excluded"] = len(points) - len(finite)
        k = self.k if self.k is not None else default_prescreen_k(len(points))
        ranked = sorted(points, key=lambda p: scores[pp_key(p)])
        survivors = ranked[: max(1, k)]

        seed = None
        if self.warm_start is not None:
            seed = project_point(space, self.warm_start)
        if seed is not None:
            skey = pp_key(seed)
            survivors = [p for p in survivors if pp_key(p) != skey]
            # the seed leads: it becomes the measured incumbent adaptive
            # costs prune against, so refinement runs stay short.  It
            # extends the survivor list (k+1 finals) rather than evicting
            # the k-th-ranked candidate — the seed is *additional* evidence,
            # and displacing a prescreen pick would make a stale sibling
            # winner able to shadow this class's own best candidate.
            survivors.insert(0, seed)

        finals = self.finals or ExhaustiveSearch(on_trial=self.on_trial)
        if getattr(finals, "needs_budget", False) and not getattr(
            cost, "supports_budget", False
        ):
            measured = lambda p, budget: cost(p)  # noqa: E731
        else:
            measured = cost
        tr = current_tracer()
        if tr is None:
            result = finals.run(space.subset(survivors), measured)
        else:
            with tr.span(
                "search.finals", cat="search", survivors=len(survivors),
                warm_seeded=seed is not None,
            ) as attrs:
                result = finals.run(space.subset(survivors), measured)
                attrs["best_pp"] = pp_key(result.best.point)
        result.prescreen_evaluations = len(points)
        result.prescreen_costs = scores
        return result
