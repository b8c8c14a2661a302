#!/usr/bin/env python3
"""Run one cell of the benchmark of ``repro_torch`` once, on the card.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell's configuration, job and per-layer
metrics are the files ``BENCHMARK.json`` names (see ``harness/manifest.py``).
Set-up runs from process start to the window; the window measures for
``--seconds``; then the program's state is freed and the plain reference
decides ``correct``.  The last line of standard output is the result
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and last ``checks``: each number compared
beside its limit); run details come on the lines before it, and the
numbers compared again as the last lines of standard error.  Every cache
the program builds (its nvcc libraries, its TuningDB) lives at a fixed
path under ``bench/.cache/``.  Without CUDA, or with fewer cards than the
cell asks for, it exits 2 and prints no result.
"""
import os
import sys
import time
from pathlib import Path

T_FIRST = time.perf_counter()
BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = BENCH / ".cache"
os.environ["REPRO_TORCH_BUILD_DIR"] = str(CACHE / "build")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

import argparse  # noqa: E402

from harness import cell as run_cell  # noqa: E402
from harness import device as dev  # noqa: E402
from harness import manifest  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t0 = run_cell.process_start() or T_FIRST

    cell = manifest.find_cell(args.workload)
    import torch

    try:
        dev.require_cards(torch, cell.entry["chips"])
    except dev.NoCard as exc:
        return run_cell.main_error(f"[card] {exc}")
    device = torch.device("cuda:0")
    dev.say(dev.describe(torch, cell.entry["chips"]))
    clocks = dev.ClockLog()
    out = run_cell.drive(cell, args.seed, args.seconds, bool(args.trace), t0, device, clocks)
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": cell.entry["chips"], "memory_peak_bytes": out.memory_peak_bytes}
    line = run_cell.result_line(cell, out, bool(args.trace), info)
    if out.trace is not None:
        kinds = {k: round(v, 6) for k, v in out.trace.seconds_by_kind().items()}
        out.details.append(f"[trace] {len(out.trace.ops)} device operations, busy "
                           f"{out.trace.busy_s:.6f} s of {out.trace.window_s:.6f} s; by kind {kinds}")
    details = clocks.lines() + out.details + [
        f"[run] {args.workload} seed {args.seed} seconds {args.seconds} trace {args.trace}: "
        f"set-up {out.setup_s:.3f} s, window {out.window_s:.3f} s, peak memory "
        f"{out.memory_peak_bytes} B, process {time.perf_counter() - t0:.1f} s"]
    return run_cell.finish(line, details)


if __name__ == "__main__":
    sys.exit(main())
