#!/usr/bin/env python3
"""The serve CLI's drift watch in two trees of the repo, A B B A.

    python3 scripts/serve_ab.py PARENT_TREE CHANGE_TREE

In each tree in the order parent, change, change, parent it runs the serve
CLI twice on one fresh tuning DB, as ``chip_smoke.py``'s ``[drift] serve``
phase does: tinyllama-1.1b at full width, the mixed trace, 64 requests
(the tuning run) then 128 (the recall run), with ``--background-tune
--fleet-workers 2 --drift-factor 2 --device-key``.  Prints each run's
drift and throughput lines and the DB's lifecycle events.  Each tree is a
checkout of the repo (``git archive`` unpacked); the kernels build into a
temporary directory shared by the runs.  Needs the card.
"""
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path


def cli(tree: Path, build: str, args) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(tree / "src"), REPRO_TORCH_BUILD_DIR=build)
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch",
                           "tinyllama-1.1b", "--full", "--trace", "mixed", *args], env=env,
                          cwd=str(tree), capture_output=True, text=True, timeout=600)


def events(db: str):
    with open(db) as f:
        data = json.load(f)
    out = []
    for key, entry in data.get("entries", {}).items():
        for ev in entry.get("events", []) if isinstance(entry, dict) else []:
            out.append((str(entry.get("bp", key))[:160], ev))
    return out


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    trees = {"parent": Path(sys.argv[1]).resolve(), "change": Path(sys.argv[2]).resolve()}
    build = tempfile.mkdtemp(prefix="serve_ab_build_")
    for name in ("parent", "change", "change", "parent"):
        tree = trees[name]
        db = os.path.join(tempfile.mkdtemp(prefix="serve_ab_db_"), "db.json")
        for n in (64, 128):
            res = cli(tree, build, ["--requests", str(n), "--background-tune",
                                    "--fleet-workers", "2", "--drift-factor", "2",
                                    "--device-key", "--tuning-db", db])
            lines = [ln for ln in res.stdout.splitlines() if "drift" in ln or "tok/s" in ln]
            print(f"[{name}] requests {n}: exit {res.returncode}: " + " | ".join(lines))
            if res.returncode:
                print(res.stderr[-3000:])
        for key, ev in events(db):
            if ev.get("kind") in ("demoted", "promoted", "rolled_back", "canary_start"):
                print(f"[{name}] event {key}: {json.dumps(ev)[:400]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
