#!/usr/bin/env python3
"""Take the readings a cell's limits are set from, on the card, at the
cell's own size (see ``harness/control.py``): the program's on every seed
given, and the control's and the planted faults' on the first few.

    python3 bench/calibrate.py --workload <cell> --seeds 1 2 3 ... [--control 3]

Prints one ``[calibrate]`` line a seed and a summary of the lower and
upper readings per number compared.  The benchmark's runs do not run it.
"""
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
os.environ["REPRO_TORCH_BUILD_DIR"] = str(BENCH / ".cache" / "build")
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

import argparse  # noqa: E402
import json  # noqa: E402

from harness import control, manifest  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3, help="seeds that also run the control")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate.py runs on the card", file=sys.stderr)
        return 2
    cell = manifest.find_cell(args.workload)
    device = torch.device("cuda:0")
    rows = control.readings(cell, args.seeds, args.seeds[:args.control], device)
    print(json.dumps({"cell": cell.name, "summary": control.summary(rows), "rows": rows}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
