"""``BENCHMARK.json`` and the files it names, found by name.

* a configuration: the ``file`` of its entry in ``configs``, which names
  its plain reference, ``reference/<module>.py`` (:mod:`harness.family`);
* a cell's traffic mix or job: ``workloads/<cell>.json``;
* a per-layer metric's reader: ``metrics/<metric>.py``, a module with
  ``read(run) -> float | None`` (None: nothing to read in this run);
* a job kind's runner: ``harness/<kind>.py`` (:func:`harness.cell.runner_of`).

A later cell, configuration (of any family) or metric is added as files
and entries only.
"""
from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
END_TO_END_SOURCES = ("device_trace", "host_clock")


def load_manifest(root: Path = ROOT) -> Dict[str, Any]:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


@dataclass
class Cell:
    """One cell as a run needs it: its entry, its configuration's entry and
    file, its job, and the metrics it reports."""

    name: str
    entry: Dict[str, Any]
    config_entry: Dict[str, Any]
    config: Dict[str, Any]
    job: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def reports(metric: Dict[str, Any], cell: str, e2e_of_cell: Optional[set] = None) -> bool:
    """True where ``metric`` is reported in ``cell``: listed there, or, for a
    metric with no ``workloads`` key, wherever what it moves is reported."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if e2e_of_cell is None:  # an end-to-end metric with no list: every cell
        return True
    return metric["moves"] in e2e_of_cell


def find_cell(name: str, manifest: Optional[Dict[str, Any]] = None,
              bench: Path = BENCH) -> Cell:
    manifest = manifest if manifest is not None else load_manifest(bench.parent)
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    config_entry = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    with open(bench.parent / config_entry["file"]) as f:
        config = json.load(f)
    with open(bench / "workloads" / f"{name}.json") as f:
        job = json.load(f)
    e2e = [m for m in manifest["end_to_end"] if reports(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"] if reports(m, name, names)]
    return Cell(name, entry, config_entry, config, job, e2e, per_layer)


def metric_reader(name: str, bench: Path = BENCH) -> Callable[[Any], Optional[float]]:
    """``read`` of ``metrics/<name>.py``, loaded by path (a metric's name may
    hold dots)."""
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def problems(manifest: Dict[str, Any], bench: Path = BENCH) -> List[str]:
    """What in ``manifest`` breaks the benchmark's rules of form: names,
    units, sources, files found by name, and each per-layer metric's
    ``moves`` reported in every cell that reports the metric."""
    out: List[str] = []
    root = bench.parent
    cells = {w["name"]: w for w in manifest["workloads"]}
    configs = {c["name"]: c for c in manifest["configs"]}
    metrics = manifest["end_to_end"] + manifest["per_layer"]
    for kind, items in (("config", manifest["configs"]), ("cell", manifest["workloads"]),
                        ("metric", metrics)):
        seen = set()
        for item in items:
            if not NAME.match(item["name"]):
                out.append(f"{kind} name {item['name']!r}")
            if item["name"] in seen:
                out.append(f"{kind} {item['name']!r} twice")
            seen.add(item["name"])
    for m in metrics:
        if not UNIT.match(m["unit"]):
            out.append(f"unit {m['unit']!r} of {m['name']}")
        if m["better"] not in ("lower", "higher"):
            out.append(f"better of {m['name']}")
        if m["source"] not in SOURCES:
            out.append(f"source of {m['name']}")
        for cell in m.get("workloads", ()):
            if cell not in cells:
                out.append(f"{m['name']} lists unknown cell {cell}")
    for m in manifest["end_to_end"]:
        if m["source"] not in END_TO_END_SOURCES:
            out.append(f"end-to-end source of {m['name']}")
        if not 0 < m["bound"] <= 0.25:
            out.append(f"bound of {m['name']}")
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    for m in manifest["per_layer"]:
        if m["moves"] not in e2e:
            out.append(f"{m['name']} moves {m['moves']}, not an end-to-end metric")
            continue
        for cell in cells:
            if reports(m, cell, {n for n, e in e2e.items() if reports(e, cell)}) and \
                    not reports(e2e[m["moves"]], cell):
                out.append(f"{m['name']} is read in {cell}, which lacks {m['moves']}")
        if not (bench / "metrics" / f"{m['name']}.py").exists():
            out.append(f"no reader metrics/{m['name']}.py")
    for name, cell in cells.items():
        if cell["config"] not in configs:
            out.append(f"cell {name} names unknown config {cell['config']}")
        if not (bench / "workloads" / f"{name}.json").exists():
            out.append(f"no job workloads/{name}.json")
        if not NAME.match(cell["traffic"]):
            out.append(f"traffic name {cell['traffic']!r}")
        if cell["chips"] not in (1, 4):
            out.append(f"chips of {name}")
    for c in manifest["configs"]:
        if not (root / c["file"]).exists():
            out.append(f"no config file {c['file']}")
            continue
        with open(root / c["file"]) as f:
            ref = json.load(f).get("reference", "")
        if not NAME.match(ref) or "." in ref or not (bench / "reference" / f"{ref}.py").exists():
            out.append(f"config {c['name']} names no reference module reference/<name>.py")
        for key in c["reduced"]:
            if not NAME.match(key):
                out.append(f"reduced key {key!r}")
    return out
