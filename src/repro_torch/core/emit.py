"""Emit policies — candidate spaces *generated* from the architecture model.

ppOpen-AT enumerates every directive variant ahead of time from a fixed,
hand-written list.  This module replaces the hand-written part: a kernel
describes its tunable dimensions (:class:`TileDim` — extent plus a semantic
role), and an :class:`EmitPolicy` derives the candidate :class:`ParamSpace`
from an :class:`~repro_torch.core.arch.ArchSpec` — pow2 tile ladders
clipped to divisibility and the card's opt-in shared memory per block, and
a per-point estimate the staged prescreen ranks on.

Hopper meanings (the JAX package's floors are TPU lane/sublane shapes):

* a "lane" dim feeds a matrix product, so it ladders from the smallest
  tensor-core fragment edge (``arch.mma_edge``);
* a "sequential" dim is a loop *inside* one CTA (Hopper has no ordered
  grid axis to carry state on), so it ladders from a warp's width and
  adds no CTAs;
* a "grid" dim only splits the CTA count (any size works);
* a "pieces" dim is not a tile but a count: the extent is cut into that
  many contiguous pieces, one CTA each, so the CTA count is multiplied by
  the value itself and nothing is padded.

A dim's ``max_tile`` caps its ladder where the kernel maps the tile onto
threads (at most 1024 a CTA), a dim with ``pow2_only`` ladders over
powers of two alone (a kernel whose tiles are compile-time instantiations),
a dim with ``divisors`` over the divisors of its extent (a count that must
cut it evenly),
and a policy's ``grid_multiplier`` counts the CTAs a launch repeats every
tile over (the batch, the heads), so the hint sees the whole call.

The estimate charges memory time at ``bytes / (BW · min(1, CTAs / SMs))``
— a launch with fewer CTAs than SMs leaves bandwidth idle — plus a fixed
cost per *wave* of CTAs, not per CTA.

Every emitted space carries a ``signature``: a content hash over the policy,
the arch, the dims, and the resulting point list.  The TuningDB records the
signature with each final so a changed arch model *invalidates* stale
winners instead of silently recalling them (docs/arch.md).
"""
from __future__ import annotations

import hashlib
import json
import math
from dataclasses import dataclass, field
from typing import (
    Any, Callable, Dict, Mapping, Optional, Sequence, Tuple,
)

from typing import Protocol

from .arch import ArchSpec, local_arch
from .params import EmptySpace, ParamSpace, PerfParam, pp_key


# Dimension semantics → the smallest tile worth emitting (module docstring).
_SEMANTICS = ("lane", "sequential", "grid", "pieces")


@dataclass(frozen=True)
class TileDim:
    """One tunable dimension of a kernel, as the emit layer sees it.

    ``allow_padding`` marks dims the kernel can tile past the array edge
    (masking the tail), so non-dividing pow2 tiles stay candidates —
    without it a prime extent collapses to the single full-extent tile.
    ``max_tile`` is the largest tile the kernel takes (``None``: the extent).
    ``pow2_only`` marks a kernel that takes power-of-two tiles alone: the
    ladder never falls back to the full extent, and with ``allow_padding``
    it runs up to the first power of two at or past the extent.
    ``divisors`` marks a count that must divide the extent: the ladder is
    every divisor from the minimum to ``max_tile``.
    """

    name: str
    extent: int
    semantic: str = "lane"
    min_tile: Optional[int] = None
    allow_padding: bool = False
    max_tile: Optional[int] = None
    pow2_only: bool = False
    divisors: bool = False

    def __post_init__(self) -> None:
        if self.semantic not in _SEMANTICS:
            raise ValueError(
                f"TileDim {self.name!r}: unknown semantic {self.semantic!r}; "
                f"expected one of {_SEMANTICS}"
            )
        if self.extent < 1:
            raise ValueError(f"TileDim {self.name!r}: extent must be >= 1")
        if self.max_tile is not None and self.max_tile < 1:
            raise ValueError(f"TileDim {self.name!r}: max_tile must be >= 1")

    def resolved_min(self, arch: ArchSpec) -> int:
        if self.min_tile is not None:
            return max(1, self.min_tile)
        if self.semantic == "lane":
            return arch.mma_edge
        if self.semantic == "sequential":
            return arch.warp_size
        return 1


@dataclass
class EmittedSpace:
    """What an emit policy returns: the space plus everything derived from it.

    ``hints`` maps ``pp_key(point)`` to the per-point model estimates
    (``est_s``, ``vmem_bytes``, ``programs``, ``waves``, ``sm_fill``,
    ``pad_factor``) that :func:`hint_prescreen` ranks on.
    """

    space: ParamSpace
    signature: str
    arch: ArchSpec
    policy: str
    hints: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    dims: Tuple[TileDim, ...] = ()


class EmitPolicy(Protocol):
    """Anything that can turn (arch, shape BP) into an EmittedSpace."""

    name: str

    def emit(self, arch: ArchSpec, bp: Mapping[str, Any]) -> EmittedSpace:
        ...  # pragma: no cover - protocol


# Tile sizes kept per dim, and the policy's version in the space signature.
MAX_PER_DIM = 8
POLICY_VERSION = 1


def pow2_ladder(dim: TileDim, arch: ArchSpec, cap: int = MAX_PER_DIM) -> Tuple[int, ...]:
    """Candidate tile sizes for one dim: pow2 multiples of the semantic
    minimum up to the extent, clipped to divisibility (unless the dim
    allows padded tails), plus the full extent itself; none above
    ``dim.max_tile``.  At most ``cap`` values survive — the largest ones,
    since the shared-memory constraint prunes from above anyway."""
    if dim.divisors:
        hi = dim.extent if dim.max_tile is None else min(dim.extent, dim.max_tile)
        out = [v for v in range(dim.resolved_min(arch), hi + 1) if dim.extent % v == 0]
        return tuple(out[-cap:])
    if dim.pow2_only:
        out = []
        v = max(1, dim.resolved_min(arch))
        while dim.max_tile is None or v <= dim.max_tile:
            if dim.extent % v == 0 or dim.allow_padding:
                out.append(v)
            if v >= dim.extent:
                break
            v *= 2
        return tuple(out[-cap:])
    hi = dim.extent if dim.max_tile is None else min(dim.extent, dim.max_tile)
    lo = min(dim.resolved_min(arch), hi)
    out = []
    v = lo
    while v < dim.extent and v <= hi:
        if dim.extent % v == 0 or dim.allow_padding:
            out.append(v)
        v *= 2
    if dim.extent <= hi:
        out.append(dim.extent)
    out = sorted(set(out))
    return tuple(out[-cap:])


def _pad_factor(dims: Sequence[TileDim], point: Mapping[str, Any]) -> float:
    """Compute/traffic inflation from tiling past the array edge."""
    factor = 1.0
    for d in dims:
        if d.name not in point or d.semantic == "pieces":
            continue
        tile = int(point[d.name])
        padded = -(-d.extent // tile) * tile
        factor *= padded / d.extent
    return factor


def _programs(dims: Sequence[TileDim], point: Mapping[str, Any]) -> int:
    """CTAs one call launches; "sequential" dims loop inside a CTA, a
    "pieces" dim's value is its CTAs."""
    n = 1
    for d in dims:
        if d.name not in point or d.semantic == "sequential":
            continue
        if d.semantic == "pieces":
            n *= int(point[d.name])
        else:
            n *= -(-d.extent // int(point[d.name]))
    return n


class TilePolicy:
    """The default emit policy: arch-derived pow2 tile ladders.

    * ``dims(bp)`` returns the kernel's :class:`TileDim` list for a shape BP.
    * ``vmem_model(bp, point)`` returns the candidate's shared-memory bytes
      per CTA — the constraint is ``vmem_model <= arch.vmem_budget()``, so
      every emitted point launches.
    * ``traffic_model(bp, point)`` (optional) returns ``(flops, bytes)`` of
      one whole call, used for the roofline part of the per-point hint.
    * ``flop_rate(arch, bp)`` (optional) is the peak rate of the units that
      do those flops; without it they are charged at the float32 CUDA-core
      rate (``arch.peak_flops_fp32``).
    * ``latency_model(arch, bp, point)`` (optional) is the least time the
      call's chains of dependent steps take on the card, for a kernel that
      latency, not flops or bytes, bounds; the hint takes the largest of
      the three.
    * ``grid_multiplier(bp)`` (optional) is how many times the launch
      repeats the tile grid (the batch, the heads); the hint's CTA count
      includes it.
    * ``programs_model(arch, bp, point)`` (optional) is the CTA count the
      hint's waves and SM fill take, in place of the dims' count and the
      multiplier: for a kernel with more CTAs than the SMs hold at once,
      whose ``latency_model`` counts the rounds they take.
    * ``point_filter(bp, point)`` (optional) keeps only the points the
      kernel takes where the dims' ladders alone do not say so (a thread
      count that must be whole warps, a ratio of two tiles).
    """

    def __init__(
        self,
        kernel: str,
        dims: Callable[[Mapping[str, Any]], Sequence[TileDim]],
        vmem_model: Callable[[Mapping[str, Any], Mapping[str, Any]], int],
        traffic_model: Optional[
            Callable[[Mapping[str, Any], Mapping[str, Any]], Tuple[float, float]]
        ] = None,
        grid_multiplier: Optional[Callable[[Mapping[str, Any]], int]] = None,
        flop_rate: Optional[Callable[[ArchSpec, Mapping[str, Any]], float]] = None,
        latency_model: Optional[
            Callable[[ArchSpec, Mapping[str, Any], Mapping[str, Any]], float]
        ] = None,
        point_filter: Optional[
            Callable[[Mapping[str, Any], Mapping[str, Any]], bool]
        ] = None,
        programs_model: Optional[
            Callable[[ArchSpec, Mapping[str, Any], Mapping[str, Any]], int]
        ] = None,
    ) -> None:
        self.kernel = kernel
        self.name = "tile_pow2_hopper"
        self.dims = dims
        self.vmem_model = vmem_model
        self.traffic_model = traffic_model
        self.grid_multiplier = grid_multiplier
        self.flop_rate = flop_rate
        self.latency_model = latency_model
        self.point_filter = point_filter
        self.programs_model = programs_model

    # -- hints -----------------------------------------------------------

    def _hint(
        self,
        arch: ArchSpec,
        bp: Mapping[str, Any],
        dims: Sequence[TileDim],
        point: Mapping[str, Any],
    ) -> Dict[str, Any]:
        vmem = int(self.vmem_model(bp, point))
        programs = _programs(dims, point)
        if self.grid_multiplier is not None:
            programs *= int(self.grid_multiplier(bp))
        if self.programs_model is not None:
            programs = int(self.programs_model(arch, bp, point))
        waves = -(-programs // arch.sm_count)
        fill = min(1.0, programs / arch.sm_count)
        pad = _pad_factor(dims, point)
        est = waves * arch.wave_overhead_s
        flops = bytes_ = latency = 0.0
        if self.traffic_model is not None:
            flops, bytes_ = self.traffic_model(bp, point)
            flops *= pad
            bytes_ *= pad
            rate = (arch.peak_flops_fp32 if self.flop_rate is None
                    else self.flop_rate(arch, bp))
            if self.latency_model is not None:
                latency = self.latency_model(arch, bp, point)
            # idle SMs neither stream bytes nor issue flops
            est += max(flops / (rate * fill),
                       bytes_ / (arch.hbm_bandwidth * fill), latency)
        return {
            "est_s": est,
            "vmem_bytes": vmem,
            "programs": programs,
            "waves": waves,
            "sm_fill": fill,
            "pad_factor": pad,
            "flops": flops,
            "bytes": bytes_,
            "latency_s": latency,
        }

    # -- emit ------------------------------------------------------------

    def emit(
        self,
        arch: Optional[ArchSpec] = None,
        bp: Mapping[str, Any] = (),
    ) -> EmittedSpace:
        arch = arch or local_arch()
        bp = dict(bp)
        budget = int(arch.vmem_budget())
        dims = tuple(self.dims(bp))
        params = [PerfParam(d.name, pow2_ladder(d, arch)) for d in dims]

        def fits(point: Mapping[str, Any]) -> bool:
            if self.point_filter is not None and not self.point_filter(bp, point):
                return False
            return int(self.vmem_model(bp, point)) <= budget

        context = {
            "kernel": self.kernel,
            "arch": arch.name,
            "vmem_budget": budget,
            **{f"extent_{d.name}": d.extent for d in dims},
        }
        base = ParamSpace(
            params, constraint=fits,
            label=f"emitted:{self.kernel}", context=context,
        )
        feasible = list(base.points())
        if not feasible:  # pragma: no cover - base construction raises first
            raise EmptySpace(
                f"emitted:{self.kernel}: no candidate fits", context=context
            )

        hints = {
            pp_key(p): self._hint(arch, bp, dims, p) for p in feasible
        }
        ordered = sorted(
            feasible, key=lambda p: (hints[pp_key(p)]["est_s"], pp_key(p))
        )
        space = base.subset(ordered)
        space.label, space.context = base.label, base.context

        signature = space_signature(
            policy=self.name, version=POLICY_VERSION, kernel=self.kernel,
            arch=arch, dims=dims, budget=budget,
            point_keys=[pp_key(p) for p in ordered],
        )
        return EmittedSpace(
            space=space, signature=signature, arch=arch,
            policy=self.name, hints=hints, dims=dims,
        )


def space_signature(
    policy: str,
    version: int,
    kernel: str,
    arch: ArchSpec,
    dims: Sequence[TileDim],
    budget: int,
    point_keys: Sequence[str],
) -> str:
    """Content hash of an emitted space — byte-identical iff the policy,
    the arch model, the shape dims, the budget, and the resulting ordered
    candidate list are all identical."""
    payload = {
        "policy": policy,
        "version": version,
        "kernel": kernel,
        "arch": arch.bp_entries(),
        "dims": [
            {
                "name": d.name, "extent": d.extent, "semantic": d.semantic,
                "min_tile": d.min_tile, "allow_padding": d.allow_padding,
                # only when set, so the spaces of dims without them keep
                # the signatures they had before they existed
                **({} if d.max_tile is None else {"max_tile": d.max_tile}),
                **({"pow2_only": True} if d.pow2_only else {}),
                **({"divisors": True} if d.divisors else {}),
            }
            for d in dims
        ],
        "vmem_budget": budget,
        "points": list(point_keys),
    }
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def hint_prescreen(
    region: Any, bp: Any, args: tuple, kwargs: dict
) -> Optional[Any]:
    """Staged-pipeline prescreen for emitted regions: rank on the emit
    hints alone.  Torch has no compile-only artifact to read flops and
    bytes from, so nothing runs in stage 1; ``None`` when the region
    carries no hints (the op then searches single-stage)."""
    hints = getattr(region, "hints", None) or {}
    if not hints:
        return None

    def score(point: Mapping[str, Any]) -> float:
        h = hints.get(pp_key(point))
        return float(h["est_s"]) if h else math.inf

    return score
