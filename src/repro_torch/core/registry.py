"""Process-wide autotuned-op registry — the install layer, generalized.

ppOpen-AT's install-time layer generates every candidate once per *build* and
lets every later run select among them for free.  The seed repo had the
pieces (ATRegion, Tuner, TuningDB) but every call site wired them by hand,
so tuning results died with the process and nothing was shared between the
train and serve hot paths.  This module is the single place where tunable
ops live:

* a :class:`KernelSpec` names an op, knows how to map *call arguments* to a
  bucketed shape class (a :class:`~repro_torch.core.params.BasicParams`), and
  builds the op's :class:`~repro_torch.core.region.ATRegion` for one shape class;
* the :class:`Registry` holds specs and hands out
  :class:`~repro_torch.core.autotuned.AutotunedOp` dispatchers;
* :func:`autotuned` is the one-liner call sites use::

      out = autotuned("flash_attention")(q, k, v)

  First call per (kernel, shape class): TuningDB lookup → on miss, tune with
  the configured Search under a trial budget → AOT-warm the top-k candidates
  → attach a RuntimeSelector.  Every later call (same process or a fresh one
  reading the same DB file) performs zero cost evaluations.

The port's registry is its own (sharing the JAX package's would let the
two packages overwrite each other's kernels under one name).  It lazily
imports ``repro_torch.kernels`` on a name miss so the ported kernels
self-register without core depending on them at import time.  Set
``REPRO_TORCH_TUNING_DB`` to persist tuning across runs by default.
"""
from __future__ import annotations

import importlib
import os
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

from .db import TuningDB
from .params import BasicParams
from .region import ATRegion
from .search import Search
from .traffic import TrafficClass


@dataclass(frozen=True)
class KernelSpec:
    """One tunable op: shape-class extraction + region factory.

    ``shape_class(*args, **kwargs)`` maps a concrete call to the BP that keys
    the tuning database (bucket dimensions that don't affect the candidate
    family — batch size, number of heads — and keep the ones that do).
    ``make_region(bp)`` builds the candidate family for that class.
    ``cost_factory(region, bp, args, kwargs)``, when given, returns the cost
    function the tuner minimizes (e.g. an analytic model for install-time AT
    on a host without the target hardware); the default is wall-clock.
    ``traffic_class(*args, **kwargs)``, when given, maps the call to a
    :class:`~repro_torch.core.traffic.TrafficClass`; its entries extend the shape
    class BP, so each traffic class tunes — and hot-swaps — independently
    (docs/serving.md).
    ``prescreen_factory``, when given, opts the op into the staged search
    pipeline (docs/tuning.md): it returns the *cheap* stage-1 cost (analytic
    model — :func:`repro_torch.core.emit.hint_prescreen` for emitted
    regions) that ranks the full candidate space so only the
    top-k survivors pay a measured evaluation; returning ``None`` falls back
    to single-stage search for that shape class.
    """

    name: str
    make_region: Callable[[BasicParams], ATRegion]
    shape_class: Callable[..., BasicParams]
    cost_factory: Optional[
        Callable[[ATRegion, BasicParams, tuple, dict], Callable[[Mapping[str, Any]], float]]
    ] = None
    tags: Tuple[str, ...] = ()
    traffic_class: Optional[Callable[..., "TrafficClass"]] = None
    prescreen_factory: Optional[
        Callable[[ATRegion, BasicParams, tuple, dict], Optional[Callable[[Mapping[str, Any]], float]]]
    ] = None


class Registry:
    def __init__(self, providers: Tuple[str, ...] = ()) -> None:
        self._specs: Dict[str, KernelSpec] = {}
        self._ops: Dict[str, Any] = {}
        self._providers = tuple(providers)
        self._imported_providers = False
        self._lock = threading.Lock()
        self._default_db: Optional[TuningDB] = None

    # -- registration --------------------------------------------------------

    def register(self, spec: KernelSpec, replace: bool = False) -> KernelSpec:
        with self._lock:
            if spec.name in self._specs and not replace:
                raise ValueError(
                    f"kernel {spec.name!r} already registered; pass replace=True "
                    "to overwrite"
                )
            self._specs[spec.name] = spec
            self._ops.pop(spec.name, None)  # drop stale dispatcher
        return spec

    def get(self, name: str) -> KernelSpec:
        if name not in self._specs:
            self._import_providers()
        try:
            return self._specs[name]
        except KeyError:
            raise KeyError(
                f"no registered kernel {name!r}; known: {sorted(self._specs)}"
            ) from None

    def names(self, tag: Optional[str] = None) -> Tuple[str, ...]:
        self._import_providers()
        return tuple(
            sorted(
                n for n, s in self._specs.items() if tag is None or tag in s.tags
            )
        )

    def specs(self, tag: Optional[str] = None) -> Tuple[KernelSpec, ...]:
        return tuple(self.get(n) for n in self.names(tag))

    # -- default persistent DB -----------------------------------------------

    def default_db(self) -> TuningDB:
        """The registry-wide cross-run cache.

        ``REPRO_TORCH_TUNING_DB=<path>`` makes it persistent; otherwise it
        is in-memory (still shared by every op in the process).
        """
        with self._lock:
            if self._default_db is None:
                self._default_db = TuningDB(
                    os.environ.get("REPRO_TORCH_TUNING_DB")
                )
            return self._default_db

    def set_default_db(self, db: TuningDB) -> None:
        with self._lock:
            self._default_db = db
            self._ops.clear()  # ops cache selectors/states against the old DB

    # -- dispatch ------------------------------------------------------------

    def op(self, name: str, **options: Any):
        """An :class:`AutotunedOp` for ``name``.

        With no options the op is cached per name (the process-wide handle
        call sites share); with options a fresh, uncached op is built so
        callers can pin their own DB / search / budget.
        """
        from .autotuned import AutotunedOp  # local import: avoids a cycle

        if options:
            return AutotunedOp(self.get(name), registry=self, **options)
        with self._lock:
            cached = self._ops.get(name)
        if cached is not None:
            return cached
        op = AutotunedOp(self.get(name), registry=self)
        with self._lock:
            return self._ops.setdefault(name, op)

    # -- internals -----------------------------------------------------------

    def _import_providers(self) -> None:
        if self._imported_providers:
            return
        self._imported_providers = True
        for mod in self._providers:
            try:
                importlib.import_module(mod)
            except ImportError:  # pragma: no cover - missing optional provider
                pass


# The port's process-wide registry.  ``repro_torch.kernels`` registers the
# ported kernels on import; the lazy provider makes
# `autotuned("flash_attention")` work without importing it first.
REGISTRY = Registry(providers=("repro_torch.kernels",))


def register_kernel(spec: KernelSpec, replace: bool = False) -> KernelSpec:
    return REGISTRY.register(spec, replace=replace)


def get_kernel(name: str) -> KernelSpec:
    return REGISTRY.get(name)


def kernel_names(tag: Optional[str] = None) -> Tuple[str, ...]:
    return REGISTRY.names(tag)


def autotuned(name: str, **options: Any):
    """The registry front door: ``autotuned("exb")(inputs)``."""
    return REGISTRY.op(name, **options)
