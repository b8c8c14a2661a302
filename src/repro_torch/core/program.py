"""Whole-program joint autotuning — compose registered ops into one problem.

The paper's headline 1.801x is a *whole-application* number: ppOpen-AT picks
a loop variant and a thread count per kernel region so the composition is
fast, not each kernel in isolation — per-region optima shift under
whole-program pressure (shared caches, memory bandwidth, activation-memory
headroom).  The registry loop tunes each registered op greedily against
its own wall clock; this module tunes the *composition*:

* a :class:`ProgramMember` wraps one tunable region of the program — an
  :class:`~repro_torch.core.region.ATRegion` from a registered
  :class:`~repro_torch.core.registry.KernelSpec`, its shape-class BP, and an
  optional cheap prescreen (the same roofline stage the per-kernel staged
  pipeline uses);
* a :class:`ProgramSpec` flattens the members' PP spaces into one joint
  space (``"<member>.<param>"`` names), fingerprints the composition as a
  BP (the **program fingerprint** keying the TuningDB), and knows how to
  ``build`` the full program step for any joint assignment — the cost the
  tuner minimizes is the *measured whole step*, never a per-kernel proxy;
* a :class:`JointSearch` prunes the product space: per-member staged
  survivors (top-k by prescreen / recorded per-kernel trials) → capped
  rank-sum cross product → coordinate descent *across members* → measured
  finals, with the per-kernel-greedy composition always evaluated first so
  the joint winner can never be worse than greedy on the same measured
  cost (tests/test_program.py pins both properties);
* :meth:`ProgramSpec.apply` hot-applies the winner **through
  ``region.select``** per member — the paper changing directives *and*
  thread count per kernel within one run, with switching still free
  because candidates are precompiled dict entries.

Joint winners persist under the program fingerprint, so a rerun of the same
composition performs zero cost evaluations (the registry acceptance bar,
extended to programs).  The port of ``repro.core.program``, copied onto
the port's cost, db, params, region, search and tuner.
"""
from __future__ import annotations

import itertools
import json
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

from .cost import AdaptiveWallClockCost, score_points_concurrently
from .db import TuningDB
from .params import BasicParams, ParamSpace, PerfParam, pp_key
from .region import ATRegion
from .search import Search, SearchResult, Trial
from .tuner import Tuner

SEP = "."  # joint param names are "<member><SEP><param>"


# ---------------------------------------------------------------------------
# Members
# ---------------------------------------------------------------------------


@dataclass
class ProgramMember:
    """One tunable region of the program.

    ``bp`` is the member's own shape-class BP — it keys the member's
    *per-kernel* DB entries (greedy winners, recorded trials) and feeds the
    program fingerprint.  ``prescreen`` (optional) maps a member PP point to
    a cheap score; when absent, recorded per-kernel trials rank the space,
    and failing that the domain order stands.
    """

    name: str
    region: ATRegion
    bp: Optional[BasicParams] = None
    prescreen: Optional[Callable[[Mapping[str, Any]], float]] = None
    op: Optional[Any] = None  # AutotunedOp, for fast-path refresh bookkeeping
    args: tuple = ()
    kwargs: dict = field(default_factory=dict)

    def __post_init__(self) -> None:
        if SEP in self.name:
            raise ValueError(
                f"program member name {self.name!r} must not contain {SEP!r}"
            )

    @classmethod
    def from_op(
        cls, name: str, op: Any, *args: Any, **kwargs: Any
    ) -> "ProgramMember":
        """Build a member from a registered :class:`AutotunedOp` call.

        Resolves the call's shape class without tuning (the joint search is
        the tuner here) and adopts the spec's ``prescreen_factory`` as the
        member's stage-1 ranking, exactly like the per-kernel staged
        pipeline.
        """
        state = op.resolve_deferred(*args, **kwargs)
        prescreen = None
        if op.spec.prescreen_factory is not None:
            prescreen = op.spec.prescreen_factory(
                state.region, state.bp, args, kwargs
            )
        return cls(
            name=name, region=state.region, bp=state.bp, prescreen=prescreen,
            op=op, args=args, kwargs=dict(kwargs),
        )


# ---------------------------------------------------------------------------
# Flatten / unflatten
# ---------------------------------------------------------------------------


def flatten_assignment(assignment: Mapping[str, Mapping[str, Any]]) -> Dict[str, Any]:
    """``{"m": {"p": v}}`` -> ``{"m.p": v}`` (the joint PP point form)."""
    flat: Dict[str, Any] = {}
    for member, sub in assignment.items():
        for pname, v in sub.items():
            flat[f"{member}{SEP}{pname}"] = v
    return flat


def unflatten_point(point: Mapping[str, Any]) -> Dict[str, Dict[str, Any]]:
    """``{"m.p": v}`` -> ``{"m": {"p": v}}`` (member sub-points)."""
    out: Dict[str, Dict[str, Any]] = {}
    for key, v in point.items():
        member, _, pname = key.partition(SEP)
        out.setdefault(member, {})[pname] = v
    return out


# ---------------------------------------------------------------------------
# Joint search
# ---------------------------------------------------------------------------


class JointSearch(Search):
    """Pruned search over the product of per-member survivor sets.

    Stages:

    1. **survivors** — the caller (``ProgramSpec.survivors``) hands each
       member's top-k sub-points, rank-ordered by the cheap layer (roofline
       prescreen or recorded per-kernel trials).  ``groups`` holds them as
       *flattened* sub-point dicts.
    2. **capped cross product** — joint candidates enumerate in rank-sum
       order (best-ranked member points first).  When the whole product
       fits under ``cap`` every candidate is measured, so with
       ``k >= |member space|`` and ``cap=None`` this reduces *exactly* to
       the exhaustive joint argmin.
    3. **coordinate descent across members** — for a product bigger than
       the cap, descend one member at a time from the per-member-greedy
       composition: try each survivor sub-point for that member with the
       others fixed, keep the measured argmin, repeat until a full pass
       moves nothing.  This is the paper's whole-application AT loop with
       "kernel region" as the coordinate.
    4. **measured finals** — the ``final_k`` best points are re-measured at
       ``finals_budget`` (when the cost is budget-aware, e.g.
       :class:`~repro_torch.core.cost.AdaptiveWallClockCost`), so the recorded
       argmin rests on the program's most trusted measurements.

    ``start`` (the greedy composition) and ``seed`` (a warm start, e.g. a
    sibling program's winner) are always evaluated, never pruned — the
    joint winner is therefore never worse than either on the measured cost.
    """

    def __init__(
        self,
        groups: Sequence[Tuple[str, Sequence[Mapping[str, Any]]]],
        start: Optional[Mapping[str, Any]] = None,
        seed: Optional[Mapping[str, Any]] = None,
        cap: Optional[int] = 16,
        final_k: int = 3,
        finals_budget: Optional[int] = 2,
        max_passes: int = 4,
        prescreen_evaluations: int = 0,
        fresh: bool = False,
    ) -> None:
        if not groups:
            raise ValueError("JointSearch needs at least one member group")
        self.groups = [(name, [dict(p) for p in pts]) for name, pts in groups]
        for name, pts in self.groups:
            if not pts:
                raise ValueError(f"member {name!r} has no survivor points")
        self.start = dict(start) if start is not None else None
        self.seed = dict(seed) if seed is not None else None
        self.cap = cap
        self.final_k = final_k
        self.finals_budget = finals_budget
        self.max_passes = max_passes
        self.prescreen_evaluations = prescreen_evaluations
        # fresh=True (ProgramSpec.tune(force=True)): every evaluation passes
        # an explicit budget so a budget-aware caching cost (the Tuner's)
        # re-measures instead of returning recorded trials — a forced
        # re-tune must not silently recycle stale measurements.
        self.fresh = fresh

    # -- enumeration ---------------------------------------------------------

    def _merge(self, combo: Sequence[int]) -> Dict[str, Any]:
        point: Dict[str, Any] = {}
        for (name, pts), i in zip(self.groups, combo):
            point.update(pts[i])
        return point

    def _product(self) -> List[Dict[str, Any]]:
        """The full survivor cross product in rank-sum order (stable)."""
        index_lists = [range(len(pts)) for _, pts in self.groups]
        combos = sorted(itertools.product(*index_lists), key=sum)
        return [self._merge(c) for c in combos]

    def _head(self, n: int) -> List[Dict[str, Any]]:
        """The first ``n`` product points in rank-sum order, lazily.

        A best-first frontier walk over the index lattice (pop the lowest
        rank-sum combo, push its one-step successors): O(n log n) time and
        O(n) memory regardless of the product size, so a five-member
        program with sixteen survivors each never materializes 16^5 dicts
        to slice off a handful.
        """
        import heapq

        sizes = [len(pts) for _, pts in self.groups]
        origin = tuple(0 for _ in sizes)
        heap: List[Tuple[int, Tuple[int, ...]]] = [(0, origin)]
        seen = {origin}
        out: List[Dict[str, Any]] = []
        while heap and len(out) < n:
            s, combo = heapq.heappop(heap)
            out.append(self._merge(combo))
            for i, c in enumerate(combo):
                if c + 1 < sizes[i]:
                    succ = combo[:i] + (c + 1,) + combo[i + 1:]
                    if succ not in seen:
                        seen.add(succ)
                        heapq.heappush(heap, (s + 1, succ))
        return out

    def product_size(self) -> int:
        n = 1
        for _, pts in self.groups:
            n *= len(pts)
        return n

    # -- run -----------------------------------------------------------------

    def run(self, space: ParamSpace, cost) -> SearchResult:
        trials: List[Trial] = []
        evaluated: Dict[str, Trial] = {}
        fresh_budget = self.fresh and getattr(cost, "supports_budget", False)

        def eval_point(point: Dict[str, Any]) -> Optional[float]:
            key = pp_key(point)
            if key in evaluated:
                return evaluated[key].cost
            if not space.feasible(point):
                return None
            if fresh_budget:
                c = float(cost(point, 1))  # bypass recorded-trial recall
            else:
                c = float(cost(point))
            t = Trial(dict(point), c)
            evaluated[key] = t
            trials.append(t)
            return t.cost

        # incumbents first: greedy composition, then the warm seed — the
        # adaptive measured cost prunes later candidates against them, and
        # evaluating them at all is what makes "never worse than greedy" a
        # construction property rather than a hope.
        for incumbent in (self.start, self.seed):
            if incumbent is not None:
                eval_point(dict(incumbent))

        n = self.product_size()
        if self.cap is None or n <= self.cap:
            for point in self._product():
                eval_point(point)
        else:
            for point in self._head(max(1, self.cap // 2)):
                eval_point(point)
            self._descend(space, eval_point, evaluated)
        # measured finals run in *both* branches: the recorded winner must
        # rest on the program's most trusted numbers, not on one lucky
        # min_repeats=1 timing that then gets recalled forever.
        self._finals(cost, evaluated, trials)

        if not evaluated:
            raise ValueError("no feasible joint candidate to search")
        best = min(evaluated.values(), key=lambda t: t.cost)
        result = SearchResult(
            best=best, trials=trials, evaluations=len(trials),
            prescreen_evaluations=self.prescreen_evaluations,
        )
        return result

    def _descend(
        self,
        space: ParamSpace,
        eval_point: Callable[[Dict[str, Any]], Optional[float]],
        evaluated: Dict[str, Trial],
    ) -> None:
        """Coordinate descent with one *member* (not one scalar) per move."""
        budget = 2 * (self.cap or 0) or None  # hard stop for pathological spaces
        current = min(evaluated.values(), key=lambda t: t.cost).point
        current_cost = min(t.cost for t in evaluated.values())
        for _ in range(self.max_passes):
            moved = False
            for name, pts in self.groups:
                best_sub = None
                for sub in pts:
                    candidate = dict(current)
                    candidate.update(sub)
                    if pp_key(candidate) == pp_key(current):
                        continue
                    c = eval_point(candidate)
                    if c is not None and c < current_cost:
                        current_cost, best_sub, moved = c, sub, True
                    if budget is not None and len(evaluated) >= budget:
                        return
                if best_sub is not None:
                    current = dict(current)
                    current.update(best_sub)
            if not moved:
                break

    def _finals(
        self,
        cost,
        evaluated: Dict[str, Trial],
        trials: List[Trial],
    ) -> None:
        """Re-measure the leaders at a higher budget when the cost allows.

        Refinement can *raise* a leader's cost past an unrefined candidate,
        so the loop continues until the argmin itself is refined — the
        recorded winner must never rest on a single untrusted timing that
        only won because its rivals were noise-corrected upward.
        """
        if not self.finals_budget or not getattr(cost, "supports_budget", False):
            return
        refined: set = set()

        def refine(t: Trial) -> None:
            c = float(cost(t.point, self.finals_budget))
            key = pp_key(t.point)
            evaluated[key] = Trial(dict(t.point), c)
            trials.append(evaluated[key])
            refined.add(key)

        for t in sorted(evaluated.values(), key=lambda t: t.cost)[: self.final_k]:
            refine(t)
        for _ in range(len(evaluated)):  # bounded: each pass refines one more
            best = min(evaluated.values(), key=lambda t: t.cost)
            if pp_key(best.point) in refined:
                break
            refine(best)


# ---------------------------------------------------------------------------
# Program spec
# ---------------------------------------------------------------------------


@dataclass
class ProgramResult:
    """What a :meth:`ProgramSpec.tune` call produced (or recalled)."""

    point: Dict[str, Any]                 # flattened joint winner
    assignment: Dict[str, Dict[str, Any]]  # per-member sub-points
    cost: Optional[float]
    evaluations: int = 0                  # measured whole-step evaluations
    prescreen_evaluations: int = 0
    from_cache: bool = False              # winner recalled by fingerprint


class ProgramSpec:
    """A joint tuning problem over named program members.

    ``build(assignment)`` must return a zero-arg callable executing one full
    program step under that assignment; the default composes the members'
    regions sequentially on their example arguments (right for pipelines of
    standalone ops — the train and serve paths pass their own ``build``).
    ``on_apply(assignment)`` is invoked after :meth:`apply` selects every
    member, for callers that mirror the winner into caller-side state (the
    Trainer's remat directive, the serve DegreeController).
    """

    def __init__(
        self,
        name: str,
        members: Sequence[ProgramMember],
        db: Optional[TuningDB] = None,
        build: Optional[
            Callable[[Mapping[str, Mapping[str, Any]]], Callable[[], Any]]
        ] = None,
        on_apply: Optional[Callable[[Dict[str, Dict[str, Any]]], None]] = None,
        extra: Optional[Mapping[str, Any]] = None,
    ) -> None:
        if not members:
            raise ValueError("ProgramSpec needs at least one member")
        names = [m.name for m in members]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate program member names: {names}")
        self.name = name
        self.members = list(members)
        self.db = db or TuningDB()
        self._build = build
        self.on_apply = on_apply
        self.extra = dict(extra or {})
        self.last_result: Optional[ProgramResult] = None

    # -- identity ------------------------------------------------------------

    def fingerprint(self) -> BasicParams:
        """The program fingerprint: composition identity for the TuningDB.

        Combines the program name, every member's shape-class fingerprint
        *and* PP-space signature (a changed candidate domain must invalidate
        the recalled winner), plus caller ``extra`` entries (the measured
        step's own shape: batch, seq, backend).
        """
        entries: Dict[str, Any] = {"program": self.name}
        for m in self.members:
            entries[f"m_{m.name}"] = m.bp.fingerprint() if m.bp else "none"
            entries[f"s_{m.name}"] = tuple(
                (p.name, tuple(p.domain)) for p in m.region.space.params
            )
        entries.update(self.extra)
        return BasicParams.make(**entries)

    # -- joint space -----------------------------------------------------------

    def joint_space(self) -> ParamSpace:
        params: List[PerfParam] = []
        for m in self.members:
            for p in m.region.space.params:
                params.append(PerfParam(f"{m.name}{SEP}{p.name}", p.domain))
        members = self.members

        def feasible(point: Mapping[str, Any]) -> bool:
            subs = unflatten_point(point)
            return all(m.region.space.feasible(subs.get(m.name, {})) for m in members)

        return ParamSpace(params, constraint=feasible)

    def joint_region(self) -> ATRegion:
        """The program as one ATRegion: candidates are whole-step builds."""
        return ATRegion(
            f"program/{self.name}",
            self.joint_space(),
            instantiate=lambda point: self.build_executable(unflatten_point(point)),
        )

    # -- executables -----------------------------------------------------------

    def build_executable(
        self, assignment: Mapping[str, Mapping[str, Any]]
    ) -> Callable[[], Any]:
        """A zero-arg callable running one full step under ``assignment``.

        Never touches live selections — measurement must not disturb the
        hot path (the same ``select=False`` discipline the background tuner
        uses).
        """
        if self._build is not None:
            return self._build(assignment)
        fns = [
            (m, m.region.candidate(dict(assignment[m.name])))
            for m in self.members
        ]

        def step() -> Any:
            out = None
            for m, fn in fns:
                out = fn(*m.args, **m.kwargs)
            return out

        return step

    def measured_cost(
        self, warmup: int = 1, min_repeats: int = 1, max_repeats: int = 3
    ) -> AdaptiveWallClockCost:
        """Default joint cost: measured wall time of the full program step."""
        return AdaptiveWallClockCost(
            lambda point: self.build_executable(unflatten_point(point)),
            warmup=warmup, min_repeats=min_repeats, max_repeats=max_repeats,
        )

    # -- per-member staging ------------------------------------------------------

    def greedy_composition(self) -> Dict[str, Dict[str, Any]]:
        """Each member's own winner: per-kernel-greedy, the paper's baseline.

        A member whose BP has a *final* per-kernel best in the DB
        contributes that point; otherwise its live selection (the safe
        default) stands.
        """
        out: Dict[str, Dict[str, Any]] = {}
        for m in self.members:
            point = self.db.tuned_point(m.bp) if m.bp is not None else None
            if point is not None:
                try:
                    m.region.space.validate(point)
                except (KeyError, ValueError):
                    point = None
            out[m.name] = dict(point) if point is not None else dict(m.region.selected)
        return out

    def survivors(
        self, k: Optional[int] = None
    ) -> Tuple[List[Tuple[str, List[Dict[str, Any]]]], int]:
        """Per-member top-k sub-points (flattened), plus prescreen-eval count.

        Ranking priority per member: recorded per-kernel DB trials (already
        *measured* evidence) → the member's prescreen (the staged
        pipeline's cheap stage 1) → domain order.  The member's greedy
        point is never pruned.
        """
        groups: List[Tuple[str, List[Dict[str, Any]]]] = []
        prescreen_evals = 0
        greedy = self.greedy_composition()
        for m in self.members:
            points = [dict(p) for p in m.region.space.points()]
            if not points:
                raise ValueError(f"member {m.name!r} has no feasible points")
            trials = self.db.trials(m.bp) if m.bp is not None else {}
            if trials:
                order = {key: c for key, c in trials.items()}
                points.sort(key=lambda p: order.get(pp_key(p), float("inf")))
            elif m.prescreen is not None:
                scores = score_points_concurrently(m.prescreen, points)
                prescreen_evals += len(points)
                ranked = sorted(zip(points, scores), key=lambda ps: ps[1])
                points = [p for p, _ in ranked]
            kk = len(points) if k is None else max(1, k)
            chosen = points[:kk]
            g = greedy[m.name]
            if not any(pp_key(p) == pp_key(g) for p in chosen):
                chosen.insert(0, dict(g))
            flat = [
                {f"{m.name}{SEP}{pn}": v for pn, v in p.items()} for p in chosen
            ]
            groups.append((m.name, flat))
        return groups, prescreen_evals

    # -- hot apply ---------------------------------------------------------------

    def apply(self, point_or_assignment: Mapping[str, Any]) -> Dict[str, Dict[str, Any]]:
        """Hot-apply a joint point through each member's ``region.select``.

        This is the run-time switch: every member candidate is a
        precompiled dict entry, so adopting a whole-program winner costs a
        handful of dict writes (and bumps each region's version so op fast
        paths refresh their cached callables lazily).
        """
        first = next(iter(point_or_assignment.values()), None)
        if isinstance(first, Mapping):
            assignment = {k: dict(v) for k, v in point_or_assignment.items()}
        else:
            assignment = unflatten_point(point_or_assignment)
        for m in self.members:
            sub = assignment.get(m.name)
            if sub:
                m.region.select(sub)
        if self.on_apply is not None:
            self.on_apply(assignment)
        return assignment

    # -- tuning ------------------------------------------------------------------

    def tune(
        self,
        cost: Optional[Callable[..., float]] = None,
        k: Optional[int] = None,
        cap: Optional[int] = 16,
        final_k: int = 3,
        finals_budget: Optional[int] = 2,
        seed: Optional[Mapping[str, Any]] = None,
        force: bool = False,
        select: bool = True,
    ) -> ProgramResult:
        """Joint AT = argmin over the composition, measured end to end.

        A *final* DB winner under the program fingerprint short-circuits the
        whole search (zero evaluations — the cross-run cache, extended to
        programs); ``force=True`` re-tunes anyway, and passes explicit
        budgets through a budget-aware cost so recorded trials are
        *re-measured* rather than recalled (a forced re-tune after the
        machine changed must not recycle stale numbers).  ``select=True``
        applies the winner through :meth:`apply`.
        """
        bp = self.fingerprint()
        if not force:
            recalled = self.db.tuned_point(bp)
            if recalled is not None:
                if select:
                    self.apply(recalled)
                result = ProgramResult(
                    point=dict(recalled),
                    assignment=unflatten_point(recalled),
                    cost=self.db.best_cost(bp),
                    from_cache=True,
                )
                self.last_result = result
                return result

        groups, prescreen_evals = self.survivors(k)
        search = JointSearch(
            groups,
            start=flatten_assignment(self.greedy_composition()),
            seed=seed,
            cap=cap,
            final_k=final_k,
            finals_budget=finals_budget,
            prescreen_evaluations=prescreen_evals,
            fresh=force,
        )
        cost = cost or self.measured_cost()
        tuner = Tuner(self.db)
        sr = tuner.tune(self.joint_region(), bp, cost, select=False, search=search)
        winner = dict(sr.best.point)
        if select:
            self.apply(winner)
        result = ProgramResult(
            point=winner,
            assignment=unflatten_point(winner),
            cost=sr.best.cost,
            evaluations=sr.evaluations,
            prescreen_evaluations=sr.prescreen_evaluations,
        )
        self.last_result = result
        return result

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        inner = ", ".join(m.name for m in self.members)
        return f"ProgramSpec({self.name!r}, members=[{inner}])"
