"""One run of one cell, from its files to the result's line."""
from __future__ import annotations

import importlib
import json
import math
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

from . import device as dev
from . import guard, manifest
from .manifest import Cell
from .outcome import Outcome

def runner_of(cell: Cell) -> ModuleType:
    """The runner of the cell's job kind, found by name: ``"kind": "train"``
    is :mod:`harness.train`.  A runner has ``setup`` (what a run builds
    before its window, which the calibration shares) and ``run``."""
    kind = cell.job["kind"]
    if not manifest.NAME.match(kind) or "." in kind or \
            not (Path(__file__).parent / f"{kind}.py").exists():
        raise ValueError(f"unknown job kind {kind!r}")
    module = importlib.import_module(f"{__package__}.{kind}")
    if not (hasattr(module, "setup") and hasattr(module, "run")):
        raise ValueError(f"job kind {kind!r} has no runner")
    return module


def cache_dir(cell: Cell, bench: Path = manifest.BENCH) -> Path:
    """The cell's fixed cache directory inside the checkout."""
    return bench / ".cache" / cell.name


def drive(cell: Cell, seed: int, seconds: float, trace_on: bool, t0: float, device,
          clocks: dev.ClockLog, hook=None, bench: Path = manifest.BENCH) -> Outcome:
    """One run of ``cell`` by its job's runner; ``hook`` wraps what the
    window drives (the fault tests break it underneath)."""
    return runner_of(cell).run(cell, seed, seconds, trace_on, t0, device, cache_dir(cell, bench),
                               clocks, hook=hook)


def metrics_of(cell: Cell, out: Outcome, trace_on: bool,
               bench: Path = manifest.BENCH) -> Dict[str, Dict[str, Any]]:
    """The cell's end-to-end metrics (``--trace 0``) or its per-layer
    metrics (``--trace 1``), each read by its own file; a reader that finds
    nothing returns None and the metric is left out."""
    metrics: Dict[str, Dict[str, Any]] = {}
    if not trace_on:
        for m in cell.end_to_end:
            value = out.setup_s if m["name"] == "setup_s" else out.end_to_end.get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        return metrics
    for m in cell.per_layer:
        value = manifest.metric_reader(m["name"], bench)(out)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics


def result_line(cell: Cell, out: Outcome, trace_on: bool, device_info: Dict[str, Any],
                bench: Path = manifest.BENCH) -> Dict[str, Any]:
    line: Dict[str, Any] = {
        "correct": out.correct,
        "attempted": out.attempted,
        "failed": out.failed,
        "metrics": metrics_of(cell, out, trace_on, bench),
        "device": dict(device_info),
    }
    if trace_on and out.trace is not None:
        line["device"]["busy_s"] = out.trace.busy_s
        line["device"]["window_s"] = out.trace.window_s
        line["breakdown"] = out.trace.breakdown()
    line["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in out.checks.items()}
    return line


def finish(line: Dict[str, Any], details: List[str]) -> int:
    """Print the run's details, the numbers compared (last on standard
    error) and the result's line (last on standard output); 0, or 3 where
    a forbidden package was loaded (then no result is printed)."""
    found = guard.forbidden_modules()
    if found:
        dev.warn(f"[guard] the run loaded {', '.join(found)}: it must measure repro_torch alone")
        return 3
    for d in details:
        dev.say(d)
    for name, c in line["checks"].items():
        dev.warn(f"[check] {name} {c['value']!r} limit {c['limit']!r}")
    dev.warn(f"[check] correct {line['correct']}, failed {line['failed']} of {line['attempted']}")
    print(json.dumps(line), flush=True)
    return 0


def process_start() -> Optional[float]:
    """The seconds, on ``time.perf_counter``'s clock, at which this process
    started (from ``/proc``); None where that cannot be read."""
    import os
    import time

    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return None
    age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    return time.perf_counter() - max(0.0, age)


def main_error(msg: str) -> int:
    print(msg, file=sys.stderr, flush=True)
    return 2
