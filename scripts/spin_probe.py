#!/usr/bin/env python3
"""How long the stream must be kept busy before a timed call, on one CUDA card.

    python3 scripts/spin_probe.py

The tuner's trials (``core.cost.l2_flush``) and the drift watch's sampled
calls (``core.cost.spin``) keep the stream busy for ``core.cost.SPIN_S``
before the start event, so that the host has enqueued the call before the
stream reaches the event and the events time the device alone.  This
script runs, in one process, at a spin of 0.2 ms and 1 ms in turn (0.2, 1,
1, 0.2; then 0.2 and 1 again after a ``torch.profiler`` session, which
slows the host's enqueue):

* a 1-worker ``FleetCoordinator`` search over the whole emitted space of
  flash bf16 at tinyllama-1.1b width (1, 2048, 32|4, 64) and of ``exb`` at
  the GKV domain (16, 16, 128, 65), with the registry's measured cost:
  the min, median and max of the recorded trials and the default point's;
* the drift drill of ``chip_smoke.py`` (candidate ``i`` launches ``exb``
  1, 1 or 3 times), tuned and called 64 times with every call sampled:
  the samples' device times, the host's enqueue time of each sampled call
  (its wrapper's Python and launches), the watch's transitions and the
  straggler selector's switches.

Prints the card's name and power limit first.  Needs the card; builds the
kernels from ``src/repro_torch/csrc`` on first use.
"""
from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

SPINS = ((0.2e-3, "a"), (1e-3, "b"), (1e-3, "c"), (0.2e-3, "d"))
AFTER_PROFILER = ((0.2e-3, "e"), (1e-3, "f"))
DRILL_CALLS = 64


def spread(xs) -> str:
    xs = sorted(xs)
    return f"min {xs[0]:.4f} median {statistics.median(xs):.4f} max {xs[-1]:.4f}"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("spin_probe: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import repro_torch.core.cost as cost_mod
    from repro_torch.core import (
        ATRegion, AutotunedOp, BasicParams, KernelSpec, ParamSpace, PerfParam, TuningDB,
        get_kernel,
    )
    from repro_torch.fleet import DriftMonitor, FleetCoordinator
    from repro_torch.fleet.workloads import kernel_problem
    from repro_torch.kernels import _build
    from repro_torch.kernels.exb import exb as exb_mod, ref as exb_ref
    from repro_torch.kernels.flash_attention import ref as fa_ref

    print(cs.card_line(), flush=True)
    t0 = time.perf_counter()
    for name in _build.sources():
        _build.library(name)
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    device = torch.device("cuda:0")
    gen = torch.Generator(device=device).manual_seed(cs.SEED)
    cases = {
        "flash_attention": fa_ref.make_inputs(gen, dtype=torch.bfloat16, device=device,
                                              **cs.FLASH),
        "exb": (exb_ref.make_inputs(gen, dims=cs.EXB_DIMS, device=device),),
    }
    drill_input = cases["exb"][0]

    def sweep(tag: str) -> None:
        for name, args in cases.items():
            bp = get_kernel(name).shape_class(*args)
            region, space, cost = kernel_problem(name, device, args)
            default = dict(region.selected)
            db = TuningDB()
            res = FleetCoordinator(workers=1).search(
                space, cost, bp=bp, db=db, space_signature=region.space_signature)
            trials = {k: v * 1e3 for k, v in db.trials(bp).items()}
            dflt = next(v for k, v in trials.items() if json.loads(k) == default)
            print(f"[spin] {tag} {name}: {len(trials)} points, {spread(trials.values())} ms; "
                  f"winner {res.best.point} {res.best.cost * 1e3:.4f}; default {default} "
                  f"{dflt:.4f} ms", flush=True)

    def drill(tag: str) -> None:
        reps = [1, 1, 3]
        enqueue = []

        def instantiate(point):
            def run(x):
                t = time.perf_counter()
                for _ in range(reps[point["i"]]):
                    out = exb_mod.exb(x)
                enqueue.append((time.perf_counter() - t) * 1e3)
                return out
            return run

        spec = KernelSpec(
            name="spin_probe_exb",
            make_region=lambda bp: ATRegion("spin_probe_exb", ParamSpace(
                [PerfParam("i", tuple(range(len(reps))))]), instantiate),
            shape_class=lambda x: BasicParams.make(kernel="spin_probe_exb", backend="cuda"),
        )
        samples = []

        class Recording(DriftMonitor):
            def observe(self, op, state, cost, args=(), kwargs=None):
                samples.append(cost * 1e3)
                return super().observe(op, state, cost, args, kwargs)

        monitor = Recording(factor=2.0)
        op = AutotunedOp(spec, db=TuningDB(), monitor_every=1, drift=monitor)
        op(drill_input)
        enqueue.clear()
        samples.clear()
        for _ in range(DRILL_CALLS):
            op(drill_input)
        torch.cuda.synchronize()
        (state,) = op.states().values()
        print(f"[spin] {tag} drill: recorded {op.db.best_cost(state.bp) * 1e3:.4f} ms; "
              f"{len(samples)} samples {spread(samples)} ms; host enqueue {spread(enqueue)} "
              f"ms; {len(monitor.transitions)} transitions over {monitor.checks} checks, "
              f"{state.selector.switches} selector switches", flush=True)

    def both(spins) -> None:
        for spin_s, tag in spins:
            cost_mod.SPIN_S = spin_s
            tag = f"{tag} spin {spin_s * 1e3:.1f} ms"
            sweep(tag)
            drill(tag)

    both(SPINS)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            exb_mod.exb(drill_input)
        torch.cuda.synchronize()
    prof.key_averages()
    both(tuple((s, f"{t} after a profiler session") for s, t in AFTER_PROFILER))
    return 0


if __name__ == "__main__":
    sys.exit(main())
