#!/usr/bin/env python3
"""The dry-run's memory prediction held to the card, alone: the ``[train]``
phase of ``chip_smoke.py`` on tinyllama-1.1b, then its ``[dryrun]`` phase.

    python3 scripts/dryrun_probe.py

Prints the card's name and power limit, the ``[train]`` rows' measured
peaks and the ``[dryrun]`` rows (predicted peak, measured peak, their
ratio); exits non-zero on any error of either phase.  Needs the card;
builds the kernels from ``src/repro_torch/csrc`` on first use.
"""
import importlib.util
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("dryrun_probe: no CUDA card", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from repro_torch.core import detect
    from repro_torch.kernels import _build

    print(cs.card_line())
    print("torch", torch.__version__, torch.version.cuda, sys.version)
    device = torch.device("cuda:0")
    arch = detect(device)
    worker = cs.start_dryrun_worker()
    t0 = time.perf_counter()
    for name in _build.sources():
        _build.library(name)
    print(f"[build] {time.perf_counter() - t0:.1f} s")
    errors = []
    t0 = time.perf_counter()
    tl = cs.train_tinyllama(torch, device, arch, errors)
    print(f"[time] train tinyllama {time.perf_counter() - t0:.1f} s; errors {errors}")
    torch.cuda.empty_cache()
    cs.dryrun_phase(torch, worker, tl["assignments"], errors)
    print("errors", errors)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
