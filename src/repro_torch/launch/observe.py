"""Observability CLI of the port.

The counterpart of ``repro.launch.observe``, on ``repro_torch.obs``: it
reads the files the port's serve and fleet CLIs write (``--tuning-db``,
``--trace-out``, ``--metrics-out``), and a TuningDB of either package.

    # decision audit: why is each class running the candidate it runs?
    PYTHONPATH=src python -m repro_torch.launch.observe explain --db db.json

    # DB roll-up as a metrics-style report
    PYTHONPATH=src python -m repro_torch.launch.observe report --db db.json

    # validate + summarize a Perfetto trace written by --trace-out
    PYTHONPATH=src python -m repro_torch.launch.observe trace --path trace.json

    # validate Prometheus text from --metrics-out or a live GET /metrics
    PYTHONPATH=src python -m repro_torch.launch.observe metrics --path metrics.prom
    PYTHONPATH=src python -m repro_torch.launch.observe metrics \
        --url http://127.0.0.1:8761/metrics

``trace`` and ``metrics`` exit non-zero on malformed input — they are
validators, not just pretty-printers.
"""
import argparse
import json
import sys


def cmd_report(args: argparse.Namespace) -> int:
    from repro_torch.core import TuningDB
    from repro_torch.obs import MetricsRegistry
    from repro_torch.obs.explain import db_summary

    db = TuningDB(args.db)
    registry = MetricsRegistry()
    registry.register_stats("tuning_db", db_summary(db),
                            help="tuning DB summary")
    print(registry.report(title=f"tuning DB {args.db}"))
    return 0


def cmd_trace(args: argparse.Namespace) -> int:
    """Validate the Chrome/Perfetto ``trace_event`` JSON shape and print a
    per-name event census."""
    try:
        with open(args.path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"ERROR: cannot read trace {args.path}: {e}")
        return 1
    events = doc.get("traceEvents") if isinstance(doc, dict) else None
    if not isinstance(events, list):
        print("ERROR: not a trace_event document "
              "(expected {'traceEvents': [...]})")
        return 1
    problems = []
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "i", "M"):
            problems.append(f"event {i}: unknown phase {ph!r}")
            continue
        if not isinstance(ev.get("name"), str):
            problems.append(f"event {i}: missing name")
        if ph != "M" and not isinstance(ev.get("ts"), int):
            problems.append(f"event {i}: non-integer ts")
        if ph == "X" and not isinstance(ev.get("dur"), int):
            problems.append(f"event {i}: complete event without integer dur")
        if not isinstance(ev.get("pid"), int) or not isinstance(ev.get("tid"), int):
            problems.append(f"event {i}: missing pid/tid")
    if problems:
        for p in problems[:10]:
            print(f"ERROR: {p}")
        return 1
    tracks = {
        ev["tid"]: ev["args"]["name"]
        for ev in events if ev.get("ph") == "M" and ev.get("name") == "thread_name"
    }
    census = {}
    for ev in events:
        if ev.get("ph") == "M":
            continue
        key = f"{tracks.get(ev['tid'], ev['tid'])}/{ev['name']}"
        census[key] = census.get(key, 0) + 1
    n = sum(census.values())
    print(f"trace OK: {n} events on {len(tracks)} tracks ({args.path})")
    for key in sorted(census):
        print(f"  {key} x{census[key]}")
    return 0


def cmd_metrics(args: argparse.Namespace) -> int:
    from repro_torch.obs import parse_prometheus

    if args.url:
        from urllib.request import urlopen

        try:
            with urlopen(args.url, timeout=args.timeout) as resp:
                text = resp.read().decode()
        except OSError as e:
            print(f"ERROR: cannot fetch {args.url}: {e}")
            return 1
        source = args.url
    else:
        try:
            with open(args.path) as f:
                text = f.read()
        except OSError as e:
            print(f"ERROR: cannot read {args.path}: {e}")
            return 1
        source = args.path
    try:
        families = parse_prometheus(text)
    except ValueError as e:
        print(f"ERROR: malformed Prometheus text from {source}: {e}")
        return 1
    n = sum(len(samples) for samples in families.values())
    print(f"metrics OK: {len(families)} families, {n} samples ({source})")
    for name in sorted(families):
        for labels, value in families[name]:
            body = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
            print(f"  {name}{{{body}}} = {value}" if body
                  else f"  {name} = {value}")
    return 0


def cmd_explain(args: argparse.Namespace) -> int:
    from repro_torch.core import TuningDB
    from repro_torch.obs.explain import explain_all, explain_fingerprint, render_report

    db = TuningDB(args.db)
    if args.fingerprint:
        try:
            reports = [explain_fingerprint(db, args.fingerprint)]
        except KeyError as e:
            print(f"ERROR: {e.args[0]}")
            return 1
    else:
        reports = explain_all(db, kernel=args.kernel)
    if not reports:
        scope = f"kernel {args.kernel!r}" if args.kernel else "DB"
        print(f"no entries in {scope} ({args.db})")
        return 1
    if args.json:
        print(json.dumps(reports, indent=2, sort_keys=True, default=str))
        return 0
    for i, report in enumerate(reports):
        if i:
            print()
        print(render_report(report))
    return 0


def main() -> None:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.observe")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("report", help="tuning-DB roll-up via the registry")
    p.add_argument("--db", required=True, help="TuningDB path")
    p.set_defaults(fn=cmd_report)

    p = sub.add_parser("trace", help="validate + summarize a Perfetto trace")
    p.add_argument("--path", required=True, help="trace JSON from --trace-out")
    p.set_defaults(fn=cmd_trace)

    p = sub.add_parser("metrics", help="validate Prometheus exposition text")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--path", help="file from --metrics-out")
    src.add_argument("--url", help="live endpoint, e.g. http://host:port/metrics")
    p.add_argument("--timeout", type=float, default=5.0)
    p.set_defaults(fn=cmd_metrics)

    p = sub.add_parser("explain", help="tuning-decision audit per shape class")
    p.add_argument("--db", required=True, help="TuningDB path")
    p.add_argument("--kernel", default=None, help="restrict to one kernel class")
    p.add_argument("--fingerprint", default=None, help="one exact entry")
    p.add_argument("--json", action="store_true", help="structured output")
    p.set_defaults(fn=cmd_explain)

    args = ap.parse_args()
    sys.exit(args.fn(args))


if __name__ == "__main__":
    main()
