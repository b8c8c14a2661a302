"""Canned fleet workloads.

The port's copy of ``repro.fleet.workloads``.  Two kinds of search problem
the fleet CLI and ``chip_smoke.py`` drive:

* ``demo`` — a module-level *picklable* analytic cost over a small grid:
  what the ``multiprocessing`` spawn backend exercises (no tensors, a
  deterministic winner, identical across worker counts and shard
  policies).  It is a copy of the JAX package's problem, so both packages'
  coordinators can be held against each other on it.
* the five registered kernels — real regions on example inputs of the JAX
  package's shapes, costed by the port's measured cost (CUDA-event device
  time after an L2 flush, under the card's timing lock: the yardstick the
  registry's own search ranks on).  Thread backend only: the cost closes
  over live tensors, which do not cross a spawn boundary.
"""
from __future__ import annotations

import json
import math
import os
from typing import Any, Callable, Mapping, Optional, Tuple

import torch

from ..core.params import ParamSpace, PerfParam

KERNELS = ("exb", "flash_attention", "rglru_scan", "ssm_scan", "stress")

# crashing_demo_cost control (set by crash-resume tests): the JSON point
# whose first evaluation kills the worker process, and the marker file that
# makes the kill one-shot (so the resumed run completes).
CRASH_POINT_ENV = "REPRO_FLEET_CRASH_POINT"
CRASH_ONCE_ENV = "REPRO_FLEET_CRASH_ONCE"

DEMO_VARIANT_PENALTY = {"ij": 0.00, "ji": 0.07, "fused": 0.21}


def demo_space(blocks: int = 6) -> ParamSpace:
    """A small block × loop-variant grid (the paper's two PP axes)."""
    return ParamSpace([
        PerfParam("block", tuple(2 ** i for i in range(3, 3 + blocks))),
        PerfParam("variant", tuple(sorted(DEMO_VARIANT_PENALTY))),
    ])


def demo_cost(point: Mapping[str, Any]) -> float:
    """Deterministic analytic cost with a unique argmin (block=64, ij).

    Module-level on purpose: the spawn backend pickles this by reference.
    """
    return (
        abs(math.log2(int(point["block"]) / 64.0))
        + DEMO_VARIANT_PENALTY[str(point["variant"])]
    )


def crashing_demo_cost(point: Mapping[str, Any]) -> float:
    """``demo_cost`` with an env-driven one-shot worker kill (test seam).

    When ``REPRO_FLEET_CRASH_POINT`` holds a JSON point and
    ``REPRO_FLEET_CRASH_ONCE`` a marker-file path, the *first* evaluation of
    that point touches the marker and hard-kills the worker process
    (``os._exit``: what a SIGKILL or an out-of-memory kill looks like to the
    coordinator).  Later evaluations see the marker and behave normally, so
    a crash-resume test sees the second attempt complete from the synced
    scratch state.
    """
    poison = os.environ.get(CRASH_POINT_ENV)
    marker = os.environ.get(CRASH_ONCE_ENV)
    if poison and marker and not os.path.exists(marker):
        if json.loads(poison) == dict(point):
            with open(marker, "w") as f:
                f.write("crashed\n")
            os._exit(1)
    return demo_cost(point)


def example_args(name: str, device: Any = "cuda") -> Tuple[Any, ...]:
    """Example inputs for one registered kernel, of the JAX package's
    shapes, drawn from a ``torch.Generator`` seeded 0 on ``device``."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(0)

    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32, device=device)

    if name == "flash_attention":
        q = normal(2, 256, 4, 64)
        return (q, q, q)
    if name == "ssm_scan":
        b, seq, d, n = 2, 256, 512, 16
        x = normal(b, seq, d)
        dt = torch.full((b, seq, d), 0.01, dtype=torch.float32, device=device)
        A = normal(d, n) * 0.1
        Bc = normal(b, seq, n)
        Cc = normal(b, seq, n)
        D = torch.ones(d, dtype=torch.float32, device=device)
        return (x, dt, A, Bc, Cc, D)
    if name == "rglru_scan":
        b, seq, w = 2, 256, 512
        x = normal(b, seq, w)
        r = torch.sigmoid(normal(b, seq, w))
        i = torch.sigmoid(normal(b, seq, w))
        lam = torch.sigmoid(normal(w))
        return (x, r, i, lam)
    if name == "exb":
        from ..kernels.exb.ref import make_inputs

        return (make_inputs(gen, dims=(16, 16, 128, 65), device=device),)
    if name == "stress":
        from ..kernels.stress.ref import make_inputs

        return (make_inputs(gen, dims=(16, 16, 32), device=device),)
    raise KeyError(f"unknown kernel {name!r}; known: {KERNELS} + ('demo',)")


def kernel_problem(
    name: str, device: Any = "cuda", args: Optional[Tuple[Any, ...]] = None
) -> Tuple[Any, ParamSpace, Callable[[Mapping[str, Any]], float]]:
    """(region, space, measured cost) for one registered kernel.

    ``args`` (optional) are the call's inputs, e.g. a model's full-width
    shapes; by default :func:`example_args` on ``device``.  The cost is the
    registry's own measured cost on those inputs
    (:func:`repro_torch.core.autotuned._wallclock_cost`).
    """
    from ..core.autotuned import _wallclock_cost
    from ..core.registry import get_kernel

    spec = get_kernel(name)
    args = tuple(args) if args is not None else example_args(name, device)
    bp = spec.shape_class(*args)
    region = spec.make_region(bp)
    return region, region.space, _wallclock_cost(region, args, {})
