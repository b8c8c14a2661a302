"""AT regions — the ``!oat$ install Exchange(...) region start/end`` analogue.

In ppOpen-AT the software developer brackets a loop nest with directives; the
preprocessor generates all tuning candidates as subroutines and a dispatcher
that calls the selected one.  In the port the same three pieces are:

* a :class:`~repro_torch.core.params.ParamSpace` — the candidate family,
* ``instantiate(point) -> callable`` — the "generated subroutine" for one
  candidate (a kernel launch with that point's tiles),
* :class:`ATRegion` — the dispatcher: calls the currently-selected candidate,
  can be pointed at a tuning DB so selection follows the tuner's argmin.

All candidates exist ahead of time (ppOpen-AT's "light-load AT, no dynamic
code generation"): the kernels are compiled once per process with tiles as
runtime arguments, and ``precompile()`` warms every candidate by launching
it once on example arguments, so run-time switching is a dict lookup.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Sequence

from .cost import _block
from .db import TuningDB
from .params import BasicParams, ParamSpace, pp_key


class ATRegion:
    """A tunable computation with a finite, pre-generated candidate family.

    ``instantiate(point)`` must return a *pure* callable; every candidate
    must be semantically identical (the tests assert allclose across the
    whole family against the region's ``oracle``).
    """

    def __init__(
        self,
        name: str,
        space: ParamSpace,
        instantiate: Callable[[Mapping[str, Any]], Callable[..., Any]],
        oracle: Optional[Callable[..., Any]] = None,
        space_signature: Optional[str] = None,
        hints: Optional[Mapping[str, Mapping[str, Any]]] = None,
        arch: Optional[Any] = None,
    ) -> None:
        self.name = name
        self.space = space
        self.instantiate = instantiate
        self.oracle = oracle
        # emitted-space provenance (core/emit.py): the signature gates DB
        # final recall — a region whose space was emitted under a different
        # arch model must re-tune, not silently recall the stale winner
        self.space_signature = space_signature
        self.hints = dict(hints) if hints else None
        self.arch = arch
        self.selected: Dict[str, Any] = space.default()
        self._compiled: Dict[str, Callable[..., Any]] = {}
        # bumped on every (re-)selection and invalidation: dispatch fast
        # paths cache "the selected candidate's callable" against this, so
        # a RuntimeSelector demotion refreshes them lazily with one integer
        # compare per call
        self.version = 0

    # -- selection -------------------------------------------------------------

    def select(self, point: Mapping[str, Any]) -> None:
        self.space.validate(point)
        self.selected = dict(point)
        self.version += 1

    def invalidate(self) -> None:
        """Drop every materialized candidate (the family itself changed)."""
        self._compiled.clear()
        self.version += 1

    def select_from_db(self, db: TuningDB, bp: BasicParams) -> bool:
        """Adopt the tuned argmin for this BP if the DB has one."""
        best = db.best_point(bp)
        if best is not None:
            self.select(best)
            return True
        return False

    # -- execution -------------------------------------------------------------

    def candidate(self, point: Mapping[str, Any]) -> Callable[..., Any]:
        key = pp_key(point)
        if key in self._compiled:
            return self._compiled[key]
        fn = self.instantiate(point)
        self._compiled[key] = fn
        return fn

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self.candidate(self.selected)(*args, **kwargs)

    # -- ahead-of-time candidate generation -------------------------------------

    def precompile(
        self,
        example_args: Sequence[Any],
        points: Optional[Sequence[Mapping[str, Any]]] = None,
    ) -> int:
        """Warm candidates so run-time selection never pays a first launch.

        Each candidate is launched once on ``example_args`` and waited for,
        which builds the kernels on first use and surfaces a launch the
        card refuses here rather than on the hot path.  Returns the number
        of candidates warmed.
        """
        pts = list(points) if points is not None else list(self.space.points())
        count = 0
        for point in pts:
            key = pp_key(point)
            if key in self._compiled:
                continue
            fn = self.instantiate(point)
            _block(fn(*example_args))
            self._compiled[key] = fn
            count += 1
        return count

    def compiled_points(self) -> int:
        return len(self._compiled)

    def is_compiled(self, point: Mapping[str, Any]) -> bool:
        """True if this candidate is already materialized (warm)."""
        return pp_key(point) in self._compiled

    def is_compiled_key(self, key: str) -> bool:
        return key in self._compiled

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"ATRegion({self.name!r}, space={self.space!r}, "
            f"selected={self.selected})"
        )
