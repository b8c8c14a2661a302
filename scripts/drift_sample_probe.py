#!/usr/bin/env python3
"""The drift watch's CUDA samples with and without the host-bound guard, on
one CUDA card.

    python3 scripts/drift_sample_probe.py [--reps N]

Runs ``chip_smoke.py``'s drift drill (candidate ``i`` launches ``exb`` 1, 1
or 3 times: tuned, 64 healthy monitored calls, then the winner slowed to 4
launches until the lifecycle ends) ``N`` times in each of four settings, in
the order guarded, unguarded, unguarded, guarded:

* guarded: ``core.cost.sampled_call`` as the port runs it, which drops a
  sample whose host enqueue outlasted the spin before it;
* unguarded: every sample kept (the event time after the spin, as before
  the guard);

each on a quiet host and beside a Python thread that spins on the
interpreter lock (so the drill's enqueue waits for it, as on a loaded
serving host).  Prints, for each drill, the healthy run's transitions,
checks and dropped samples, whether the slowed run went through the whole
lifecycle, and a summary a setting.  Prints the card's name and power limit
first.  Needs the card; builds the kernels from ``src/repro_torch/csrc`` on
first use.
"""
from __future__ import annotations

import argparse
import importlib
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


class Contender:
    """A thread that keeps taking the interpreter lock while it runs."""

    def __init__(self) -> None:
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        while not self._stop.is_set():
            x = 0
            for i in range(20000):
                x += i

    def __enter__(self) -> "Contender":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=6)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("drift_sample_probe: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.core import cost as cost_mod
    from repro_torch.kernels import _build

    autotuned_mod = importlib.import_module("repro_torch.core.autotuned")
    print(cs.card_line(), flush=True)
    t0 = time.perf_counter()
    _build.library("exb")
    print(f"[build] exb {time.perf_counter() - t0:.1f} s", flush=True)
    device = torch.device("cuda:0")
    guarded = cost_mod.sampled_call

    def unguarded(fn, dev):
        return cost_mod.timed_call(fn, cost_mod.spin(dev))

    summary = {}
    for guard, contended in ((True, False), (False, False), (False, False), (True, False),
                             (True, True), (False, True), (False, True), (True, True)):
        autotuned_mod.sampled_call = guarded if guard else unguarded
        tag = f"{'guarded' if guard else 'unguarded'} {'contended' if contended else 'quiet'}"
        row = summary.setdefault(tag, dict(drills=0, healthy_transitions=0, failed=0,
                                           dropped=0, checks=0))
        for _ in range(args.reps):
            errors: list = []
            if contended:
                with Contender():
                    out = cs.drift_drill(torch, device, errors)
            else:
                out = cs.drift_drill(torch, device, errors)
            h = out["healthy"]
            row["drills"] += 1
            row["healthy_transitions"] += h["transitions"]
            row["failed"] += bool(errors)
            row["dropped"] += h["host_bound_samples"]
            row["checks"] += h["checks"]
            print(f"[probe] {tag}: healthy {h['transitions']} transitions over {h['checks']} "
                  f"checks, {h['host_bound_samples']} dropped, EWMA {h['ewma_ms']} ms against "
                  f"{h['recorded_ms']:.4f}; slowed {out['events']} in {out['slowed_calls']} "
                  f"calls, {out['slowed_host_bound_samples']} dropped; errors {len(errors)}",
                  flush=True)
    autotuned_mod.sampled_call = guarded
    for tag, row in summary.items():
        print(f"[summary] {tag}: {row['drills']} drills, {row['failed']} failed, "
              f"{row['healthy_transitions']} healthy transitions, {row['dropped']} of "
              f"{64 * row['drills']} healthy samples dropped, {row['checks']} checks")
    return 0


if __name__ == "__main__":
    sys.exit(main())
