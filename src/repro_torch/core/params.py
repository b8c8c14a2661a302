"""FIBER parameter vocabulary (paper §II.A).

FIBER defines autotuning as::

    AT = argmin_{PP} cost(PP | BP)

at each of three layers (install / before-execution / run-time), where

* **BP** (basic parameter set) — facts fixed by the user / environment:
  problem size, mesh shape, max parallelism degree.  BP is *identity*: the
  tuning database is keyed by a BP fingerprint.
* **PP** (performance parameter set) — the knobs the tuner may move: loop
  variant, parallelism degree, block shape, sharding rule, ...

This module gives both sets a concrete, hashable, JSON-serializable form.
"""
from __future__ import annotations

import hashlib
import itertools
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, Mapping, Sequence, Tuple


# ---------------------------------------------------------------------------
# Basic parameter set (BP)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BasicParams:
    """The FIBER basic parameter set: everything the tuner must NOT change.

    ``entries`` maps names to plain values (ints, strs, tuples).  Examples:
    ``{"arch": "gkv_exb", "iv": 16, "iz": 16, "mx": 128, "my": 65}`` or
    ``{"arch": "llama3-405b", "shape": "train_4k", "mesh": "pod16x16"}``.
    """

    entries: Tuple[Tuple[str, Any], ...]

    @classmethod
    def make(cls, **kwargs: Any) -> "BasicParams":
        return cls(tuple(sorted((k, _freeze(v)) for k, v in kwargs.items())))

    def __getitem__(self, key: str) -> Any:
        for k, v in self.entries:
            if k == key:
                return v
        raise KeyError(key)

    def get(self, key: str, default: Any = None) -> Any:
        try:
            return self[key]
        except KeyError:
            return default

    def asdict(self) -> Dict[str, Any]:
        return dict(self.entries)

    def with_entries(self, **extra: Any) -> "BasicParams":
        """A new BP with ``extra`` merged in (later keys win).

        This is how orthogonal BP dimensions compose: a kernel's shape class
        extended with its traffic class and mesh fingerprint stays one flat,
        fingerprintable key.
        """
        merged = dict(self.entries)
        merged.update(extra)
        return BasicParams.make(**merged)

    def fingerprint(self) -> str:
        """Stable hash used as the tuning-database key (computed once)."""
        fp = getattr(self, "_fp", None)
        if fp is None:
            blob = json.dumps(self.entries, sort_keys=True, default=str)
            fp = hashlib.sha256(blob.encode()).hexdigest()[:16]
            object.__setattr__(self, "_fp", fp)  # frozen dataclass memo
        return fp

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        inner = ", ".join(f"{k}={v!r}" for k, v in self.entries)
        return f"BP({inner})"


def _freeze(v: Any) -> Any:
    if isinstance(v, list):
        return tuple(_freeze(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    return v


# ---------------------------------------------------------------------------
# Performance parameter set (PP)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PerfParam:
    """One tunable knob: a name and its finite candidate domain.

    The paper's two PPs are ``loop_variant`` (Figs 1-10) and ``num_threads``
    (1..32).  Ours add block shapes, sharding rules, remat policies, ...
    Domains are always finite and explicit — ppOpen-AT generates *all*
    candidates ahead of time, and so do we.
    """

    name: str
    domain: Tuple[Any, ...]

    def __post_init__(self) -> None:
        if len(self.domain) == 0:
            raise ValueError(f"PerfParam {self.name!r} has an empty domain")
        if len(set(map(repr, self.domain))) != len(self.domain):
            raise ValueError(f"PerfParam {self.name!r} has duplicate candidates")


class EmptySpace(ValueError):
    """A ParamSpace whose constraint rejects every cartesian point.

    Raised at construction (and by ``default()``/``shard()`` as a backstop)
    so an over-tight constraint — e.g. a shared-memory budget smaller than
    any candidate tile — fails where the space is built, naming the
    constraint and the architecture values, instead of surfacing as a
    confusing downstream search failure.
    """

    def __init__(self, message: str, label=None, context=None) -> None:
        super().__init__(message)
        self.label = label
        self.context = dict(context or {})


# Constructor-time emptiness is only provable by enumerating the whole
# cartesian product; past this many probes we defer to default()/points().
_EMPTY_PROBE_CAP = 4096


class ParamSpace:
    """The cartesian PP space plus an optional feasibility predicate.

    ``constraint(point) -> bool`` prunes infeasible combinations (e.g. a
    tile whose shared-memory footprint exceeds what one CTA may use — the
    card's version of "don't give each thread 2 iterations").  ``label``/``context`` name
    the space and the values its constraint was derived from; both ride
    along on the :class:`EmptySpace` error when nothing survives.
    """

    def __init__(
        self, params: Sequence[PerfParam], constraint=None,
        label: str = None, context: Mapping[str, Any] = None,
    ) -> None:
        names = [p.name for p in params]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate PerfParam names: {names}")
        self.params: Tuple[PerfParam, ...] = tuple(params)
        self.constraint = constraint
        self.label = label
        self.context = dict(context or {})
        self._members: Any = None  # explicit enumeration (see subset())
        if constraint is not None and self.size() <= _EMPTY_PROBE_CAP:
            for _ in self.points():
                break
            else:
                raise self._empty_error()

    def _empty_error(self) -> "EmptySpace":
        what = self.label or "ParamSpace"
        msg = f"{what}: constraint rejects all {self.size()} candidate points"
        if self.context:
            ctx = ", ".join(f"{k}={v}" for k, v in sorted(self.context.items()))
            msg += f" ({ctx})"
        return EmptySpace(msg, label=self.label, context=self.context)

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(p.name for p in self.params)

    def size(self) -> int:
        n = 1
        for p in self.params:
            n *= len(p.domain)
        return n

    def feasible(self, point: Mapping[str, Any]) -> bool:
        return self.constraint is None or bool(self.constraint(dict(point)))

    def points(self) -> Iterator[Dict[str, Any]]:
        """Every feasible PP assignment (exhaustive enumeration).

        A subset space enumerates its explicit member list instead,
        preserving the order it was built with (prescreen rank order).
        """
        if self._members is not None:
            for point in self._members:
                yield dict(point)
            return
        domains = [p.domain for p in self.params]
        for combo in itertools.product(*domains):
            point = dict(zip(self.names, combo))
            if self.feasible(point):
                yield point

    def default(self) -> Dict[str, Any]:
        """First feasible point — the untuned baseline."""
        for point in self.points():
            return point
        raise self._empty_error()

    def subset(self, points: Sequence[Mapping[str, Any]]) -> "ParamSpace":
        """A space restricted to an explicit candidate list.

        The staged pipeline's measured-finals stage runs a full
        :class:`~repro_torch.core.search.Search` over prescreen survivors only;
        the subset keeps the parent's params (so ``validate`` still checks
        domains) but enumeration and feasibility are membership in
        ``points``.
        """
        members = [dict(p) for p in points]
        if not members:
            raise ValueError("ParamSpace.subset() needs at least one point")
        keys = {pp_key(p) for p in members}
        parent_feasible = self.feasible
        sub = ParamSpace(
            self.params,
            constraint=lambda p: pp_key(p) in keys and parent_feasible(p),
        )
        sub._members = members  # ordered enumeration (prescreen rank order)
        return sub

    def shard(self, n: int, policy: str = "stride") -> "Tuple[ParamSpace, ...]":
        """Deterministically partition this space into ≤ ``n`` subset spaces.

        The fleet shard protocol (docs/fleet.md): every feasible point lands
        in exactly one shard, assignment depends only on the enumeration
        order (itself deterministic), and the union of shard argmins is the
        global argmin — which is what makes the N-worker fleet search return
        the single-process winner by construction.

        ``policy="stride"`` deals points round-robin (shard ``i`` takes
        enumeration indices ``i, i+n, ...``) so heavy-tail spaces balance;
        ``policy="block"`` gives each shard one contiguous run, keeping a
        prescreen's rank order intact within a shard.  Shards that would be
        empty (fewer points than workers) are dropped, so the result may
        have fewer than ``n`` members — never an empty subset space.
        """
        if n < 1:
            raise ValueError(f"shard count must be >= 1, got {n}")
        if policy not in ("stride", "block"):
            raise ValueError(f"unknown shard policy {policy!r}; "
                             "expected 'stride' or 'block'")
        points = [dict(p) for p in self.points()]
        if not points:
            raise self._empty_error()
        if policy == "stride":
            groups = [points[i::n] for i in range(n)]
        else:
            size = -(-len(points) // n)  # ceil division: first shards fill up
            groups = [points[i * size : (i + 1) * size] for i in range(n)]
        return tuple(self.subset(g) for g in groups if g)

    def neighbours(self, point: Mapping[str, Any]) -> Iterator[Dict[str, Any]]:
        """Coordinate-move neighbourhood (for hillclimb search): all feasible
        points differing from ``point`` in exactly one parameter."""
        for p in self.params:
            for candidate in p.domain:
                if candidate == point[p.name]:
                    continue
                moved = dict(point)
                moved[p.name] = candidate
                if self.feasible(moved):
                    yield moved

    def validate(self, point: Mapping[str, Any]) -> None:
        for p in self.params:
            if p.name not in point:
                raise KeyError(f"PP point missing {p.name!r}")
            if point[p.name] not in p.domain:
                raise ValueError(
                    f"{point[p.name]!r} not in domain of {p.name!r}: {p.domain}"
                )

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        inner = ", ".join(f"{p.name}[{len(p.domain)}]" for p in self.params)
        return f"ParamSpace({inner}, size={self.size()})"


def pp_key(point: Mapping[str, Any]) -> str:
    """Canonical JSON key for one PP assignment (DB storage)."""
    return json.dumps({k: _freeze(v) for k, v in sorted(point.items())}, default=str)


def project_point(
    space: ParamSpace, point: Mapping[str, Any]
) -> "Dict[str, Any] | None":
    """Project a (possibly foreign-shape-class) PP point onto ``space``.

    Cross-shape-class warm starts reuse a neighbouring class's winner, but
    that class's domains can differ (block candidates divide *its* seq/width,
    not ours).  Per parameter: keep an in-domain value, snap a numeric value
    to the nearest numeric domain candidate, and fall back to the space
    default's value for anything else (missing params, non-numeric
    mismatches).  Returns ``None`` when the projected point is infeasible —
    a seed must never smuggle an invalid candidate past the constraint.
    """
    try:
        default = space.default()
    except ValueError:
        return None
    projected: Dict[str, Any] = {}
    for param in space.params:
        v = point.get(param.name, default[param.name])
        # compare frozen: a disk-loaded seed has JSON lists where the domain
        # has tuples, and that must still count as an exact match
        fv = _freeze(v)
        match = next((d for d in param.domain if _freeze(d) == fv), None)
        if match is not None:
            projected[param.name] = match
            continue
        numeric = [
            d for d in param.domain
            if isinstance(d, (int, float)) and not isinstance(d, bool)
        ]
        if numeric and isinstance(v, (int, float)) and not isinstance(v, bool):
            projected[param.name] = min(numeric, key=lambda d: abs(d - v))
        else:
            projected[param.name] = default[param.name]
    return projected if space.feasible(projected) else None
