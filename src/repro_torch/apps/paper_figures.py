"""The paper's Figs. 11–14 on the card: the GKV loop-exchange variants and
the Seism3D degree switch, timed as the port's tuner times any candidate.

* :func:`fig11` — every Exchange/LoopFusion variant of GKV at degree 32
  against the original loop (directive on iz, variant (4,2)); paper
  (FX100, 32 threads): directive on the outermost loop fastest, 1.791×.
* :func:`fig12` — Seism3D ``update_stress`` at variant (3,1) with a
  :class:`~repro_torch.core.degree.DegreeController` switch on every call
  (set the tuned degree on entry, restore the maximum on exit) against the
  same degree fixed; paper: at most 1.003×.
* :func:`fig13_14` — the joint (variant × degree) search over GKV through
  the port's :class:`~repro_torch.core.tuner.Tuner` and
  :class:`~repro_torch.core.db.TuningDB`; Fig. 13 is each variant at its
  best degree against the original at 32 (paper: 1.801× combined), Fig. 14
  each variant at its best degree against itself at 32 (paper: the
  innermost directive 7.727× faster at 1 thread than at 32).

Every time is device time (CUDA events around one call of a variant, all
its launches included) after :func:`~repro_torch.core.cost.l2_flush`, the
minimum of ``repeats`` runs (:class:`~repro_torch.core.cost.WallClockCost`).
A degree here is a CTA count, and 32 CTAs fill a quarter of an H100's 132
SMs where 32 threads filled the FX100 node: the figures are the paper's
experiments, not its machine.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch

from ..core import (
    BasicParams,
    DegreeController,
    ExchangeVariant,
    GKV_FIGURE_OF_VARIANT,
    LoopNest,
    Tuner,
    TuningDB,
    WallClockCost,
    enumerate_exchange_variants,
    launch_shape,
)
from ..core.arch import ArchSpec, detect
from ..core.cost import l2_flush

PAPER = {"fig11": 1.791, "fig12": 1.003, "fig13": 1.801, "fig14_innermost": 7.727}
ORIGINAL = (4, 2)   # GKV as written: the directive on iz
FULL_DEGREE = 32    # the paper's "all threads" of one node


def _device(inputs: Mapping[str, torch.Tensor]) -> torch.device:
    device = next(iter(inputs.values())).device
    if device.type != "cuda":
        raise ValueError("the paper's figures are timed on the card: pass CUDA tensors")
    return device


def region_cost(region: Any, inputs: Mapping[str, torch.Tensor], arch: Optional[ArchSpec] = None,
                repeats: int = 3) -> WallClockCost:
    """The tuner's cost of a region's candidates on ``inputs``: device time
    of one call, the L2 flushed and the stream spun before each run."""
    device = _device(inputs)
    arch = arch or detect(device)
    return WallClockCost(
        build=lambda p: (lambda fn=region.candidate(p): fn(inputs)),
        warmup=1, repeats=repeats, prepare=l2_flush(device, 2 * arch.l2_bytes),
    )


def fig11(nest: LoopNest, inputs: Mapping[str, torch.Tensor], degree: int = FULL_DEGREE,
          arch: Optional[ArchSpec] = None, repeats: int = 3) -> Dict[str, Any]:
    """Each variant at ``degree`` against the original: ``{"rows": [...],
    "best": row}``, a row ``{"variant", "figure", "s", "speedup",
    "launches", "ctas"}``."""
    variants = enumerate_exchange_variants(len(nest.lengths))
    region = nest.at_region(degrees=(degree,), variants=variants)
    cost = region_cost(region, inputs, arch, repeats)
    times = {(v.m, v.j): cost({"variant": (v.m, v.j), "degree": degree}) for v in variants}
    rows = []
    for v in variants:
        shape = launch_shape(nest.lengths, v, degree)
        key = (v.m, v.j)
        rows.append({"variant": key, "figure": GKV_FIGURE_OF_VARIANT.get(key, str(key)),
                     "s": times[key], "speedup": times[ORIGINAL] / times[key],
                     "launches": shape.launches, "ctas": shape.ctas})
    return {"rows": rows, "best": max(rows, key=lambda r: r["speedup"]),
            "paper": PAPER["fig11"]}


def fig12(nest: LoopNest, inputs: Mapping[str, torch.Tensor],
          variant: Tuple[int, int] = (3, 1), degrees: Sequence[int] = (1, 8, 32),
          tuned: int = 8, calls: int = 20, region_name: str = "update_stress") -> Dict[str, Any]:
    """``calls`` calls of ``variant`` at the tuned degree with a
    DegreeController switch each (to ``tuned`` on entry, back to the
    maximum on exit) against ``calls`` calls at the tuned degree fixed, and
    against the maximum degree fixed (the JAX benchmark's baseline): device
    time from the first call's start to the last call's end, in seconds a
    call."""
    _device(inputs)
    region = nest.at_region(degrees=degrees, variants=[ExchangeVariant(*variant)])
    region.precompile([inputs], points=[{"variant": variant, "degree": d} for d in degrees])
    ctl = DegreeController(max_degree=max(degrees))
    ctl.set_tuned(region_name, tuned)

    def timed(step: Callable[[], Any]) -> float:
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            step()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / calls

    fixed = region.candidate({"variant": variant, "degree": tuned})
    full = region.candidate({"variant": variant, "degree": max(degrees)})

    def switched() -> Any:
        with ctl.region(region_name) as d:
            return region.candidate({"variant": variant, "degree": d})(inputs)

    t_fixed = timed(lambda: fixed(inputs))
    t_switch = timed(switched)
    t_full = timed(lambda: full(inputs))
    return {"fixed_s": t_fixed, "switch_s": t_switch, "full_s": t_full,
            "ratio": t_switch / t_fixed, "ratio_vs_full": t_switch / t_full,
            "switches": ctl.switch_count, "calls": calls, "paper": PAPER["fig12"]}


def nest_params(nest: LoopNest, degrees: Sequence[int], device: torch.device) -> BasicParams:
    """The shape class of a nest's region: its name, domain, degrees and
    card."""
    return BasicParams.make(
        kernel=nest.name, dims=tuple(zip(nest.dim_names, nest.lengths)),
        degrees=tuple(degrees), backend="cuda", framework="torch",
        device=torch.cuda.get_device_name(device),
    )


def fig13_14(nest: LoopNest, inputs: Mapping[str, torch.Tensor], degrees: Sequence[int],
             db: TuningDB, arch: Optional[ArchSpec] = None,
             repeats: int = 3) -> Dict[str, Any]:
    """The joint search over GKV's (variant × degree) through the Tuner,
    its trials recorded in ``db``; per variant its best degree, Fig. 13's
    speedup over the original at degree 32 and Fig. 14's gain over the same
    variant at 32."""
    if FULL_DEGREE not in degrees:
        raise ValueError(f"Figs. 13-14 compare against degree {FULL_DEGREE}: keep it")
    t0 = time.perf_counter()
    result, region, bp = tune(nest, inputs, degrees, db, arch, repeats)
    tune_s = time.perf_counter() - t0
    costs = {(tuple(t.point["variant"]), t.point["degree"]): t.cost for t in result.trials}
    t_original = costs[(ORIGINAL, FULL_DEGREE)]
    rows = []
    for v in enumerate_exchange_variants(len(nest.lengths)):
        key = (v.m, v.j)
        per_degree = {d: costs[(key, d)] for d in degrees}
        best = min(per_degree, key=per_degree.get)
        rows.append({"variant": key, "figure": GKV_FIGURE_OF_VARIANT.get(key, str(key)),
                     "best_degree": best, "s": per_degree[best],
                     "s_at_32": per_degree[FULL_DEGREE],
                     "fig13": t_original / per_degree[best],
                     "fig14": per_degree[FULL_DEGREE] / per_degree[best]})
    best = result.best
    return {"rows": rows, "best_point": best.point, "best_s": best.cost,
            "combined": t_original / best.cost, "evaluations": result.evaluations,
            "tune_s": tune_s, "bp": bp, "region": region, "paper": PAPER}


def tune(nest: LoopNest, inputs: Mapping[str, torch.Tensor], degrees: Sequence[int],
         db: TuningDB, arch: Optional[ArchSpec] = None, repeats: int = 3):
    """The exhaustive (variant × degree) search of ``nest`` through the
    Tuner, trials and the final recorded in ``db``: (SearchResult, region,
    shape class)."""
    device = _device(inputs)
    region = nest.at_region(degrees=degrees)
    bp = nest_params(nest, degrees, device)
    return Tuner(db).tune(region, bp, region_cost(region, inputs, arch, repeats)), region, bp


def recall(nest: LoopNest, degrees: Sequence[int], db_path: str,
           device: torch.device) -> Tuple[Optional[Dict[str, Any]], Any]:
    """A fresh region over the same space as :func:`tune`'s or
    :func:`fig13_14`'s, selected from a fresh TuningDB on ``db_path``: the
    tuned point it recalls (None on a miss) and the region, with no
    candidate measured."""
    region = nest.at_region(degrees=degrees)
    point = TuningDB(db_path).tuned_point(nest_params(nest, degrees, device))
    if point is not None:
        point = dict(point, variant=tuple(point["variant"]))  # JSON keeps a list
        region.select(point)
    return point, region
