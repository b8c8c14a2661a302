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
* a "grid" dim only splits the CTA count (any size works).

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
_SEMANTICS = ("lane", "sequential", "grid")


@dataclass(frozen=True)
class TileDim:
    """One tunable dimension of a kernel, as the emit layer sees it.

    ``allow_padding`` marks dims the kernel can tile past the array edge
    (masking the tail), so non-dividing pow2 tiles stay candidates —
    without it a prime extent collapses to the single full-extent tile.
    """

    name: str
    extent: int
    semantic: str = "lane"
    min_tile: Optional[int] = None
    allow_padding: bool = False

    def __post_init__(self) -> None:
        if self.semantic not in _SEMANTICS:
            raise ValueError(
                f"TileDim {self.name!r}: unknown semantic {self.semantic!r}; "
                f"expected one of {_SEMANTICS}"
            )
        if self.extent < 1:
            raise ValueError(f"TileDim {self.name!r}: extent must be >= 1")

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
    allows padded tails), plus the full extent itself.  At most ``cap``
    values survive — the largest ones, since the shared-memory constraint prunes
    from above anyway."""
    lo = min(dim.resolved_min(arch), dim.extent)
    out = []
    v = lo
    while v < dim.extent:
        if dim.extent % v == 0 or dim.allow_padding:
            out.append(v)
        v *= 2
    out.append(dim.extent)
    out = sorted(set(out))
    return tuple(out[-cap:])


def _pad_factor(dims: Sequence[TileDim], point: Mapping[str, Any]) -> float:
    """Compute/traffic inflation from tiling past the array edge."""
    factor = 1.0
    for d in dims:
        if d.name not in point:
            continue
        tile = int(point[d.name])
        padded = -(-d.extent // tile) * tile
        factor *= padded / d.extent
    return factor


def _programs(dims: Sequence[TileDim], point: Mapping[str, Any]) -> int:
    """CTAs one call launches; "sequential" dims loop inside a CTA."""
    n = 1
    for d in dims:
        if d.name in point and d.semantic != "sequential":
            n *= -(-d.extent // int(point[d.name]))
    return n


class TilePolicy:
    """The default emit policy: arch-derived pow2 tile ladders.

    * ``dims(bp)`` returns the kernel's :class:`TileDim` list for a shape BP.
    * ``vmem_model(bp, point)`` returns the candidate's shared-memory bytes
      per CTA — the constraint is ``vmem_model <= arch.vmem_budget()``, so
      every emitted point launches.
    * ``traffic_model(bp, point)`` (optional) returns ``(flops, bytes)`` of
      one whole call, used for the roofline part of the per-point hint;
      the flops are charged at the float32 CUDA-core rate, where the port's
      kernels do them.
    """

    def __init__(
        self,
        kernel: str,
        dims: Callable[[Mapping[str, Any]], Sequence[TileDim]],
        vmem_model: Callable[[Mapping[str, Any], Mapping[str, Any]], int],
        traffic_model: Optional[
            Callable[[Mapping[str, Any], Mapping[str, Any]], Tuple[float, float]]
        ] = None,
    ) -> None:
        self.kernel = kernel
        self.name = "tile_pow2_hopper"
        self.dims = dims
        self.vmem_model = vmem_model
        self.traffic_model = traffic_model

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
        waves = -(-programs // arch.sm_count)
        fill = min(1.0, programs / arch.sm_count)
        pad = _pad_factor(dims, point)
        est = waves * arch.wave_overhead_s
        flops = bytes_ = 0.0
        if self.traffic_model is not None:
            flops, bytes_ = self.traffic_model(bp, point)
            flops *= pad
            bytes_ *= pad
            # idle SMs neither stream bytes nor issue flops
            est += max(flops / (arch.peak_flops_fp32 * fill),
                       bytes_ / (arch.hbm_bandwidth * fill))
        return {
            "est_s": est,
            "vmem_bytes": vmem,
            "programs": programs,
            "waves": waves,
            "sm_fill": fill,
            "pad_factor": pad,
            "flops": flops,
            "bytes": bytes_,
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
