"""Fleet tuning CLI of the port — sharded before-execution AT, on the card.

    PYTHONPATH=src python -m repro_torch.launch.fleet --kernel exb --workers 2
    PYTHONPATH=src python -m repro_torch.launch.fleet --kernel demo \
        --workers 2 --backend spawn --shard-policy stride --sync-every 4

The counterpart of ``repro.launch.fleet``, with the same flags and one of
its own: ``--device`` (``cuda`` unless asked for ``cpu``; no card and no
``--device cpu`` exits non-zero), where a kernel's example inputs live.
Partitions the kernel's PP space across ``--workers`` workers (in-process
threads or ``multiprocessing`` spawn), each running the existing search on
its shard against a scratch TuningDB, then merges at the barrier and
records the fleet winner — by construction the single-process winner.

``--kernel demo`` is a deterministic analytic problem (the only one the
spawn backend accepts: a kernel's cost closes over CUDA tensors); any
registered kernel name is measured on the card by the registry's own cost
(CUDA-event device time after an L2 flush; thread workers take turns on
the card's timing lock).  ``--check-equivalence`` re-runs single-worker
and demands the identical winner, which only the deterministic demo
problem can promise on a card: measured costs carry noise.

Global tuning service:

    # terminal 1 — the service, persisting to a DB file
    PYTHONPATH=src python -m repro_torch.launch.fleet --serve-db \
        --db /tmp/service-db.json --port 8761

    # terminals 2..N — one process per host, each measuring its slice
    PYTHONPATH=src python -m repro_torch.launch.fleet --kernel demo \
        --backend spawn --service-url http://127.0.0.1:8761 \
        --hosts 2 --host-index 0
    PYTHONPATH=src python -m repro_torch.launch.fleet --kernel demo \
        --backend spawn --service-url http://127.0.0.1:8761 \
        --hosts 2 --host-index 1 --check-equivalence

``--serve-db`` runs the long-lived service; each host pushes its shard's
trials and pulls everyone else's at the merge barrier, so the *last*
host's recorded winner is the global single-process winner (what
``--check-equivalence`` asserts in service mode).  ``--fault-seed`` /
``--fault-drop`` / ``--fault-dup`` / ``--fault-reorder`` wrap the
transport in the deterministic fault injector, to run the whole flow over a
deliberately lossy link.
"""
import argparse
import json
import sys


def serve(args: argparse.Namespace) -> None:
    """``--serve-db``: run the global tuning service until interrupted."""
    from repro_torch.fleet import TuningService, serve_http

    service = TuningService(path=args.db)
    server = serve_http(service, host=args.host, port=args.port)
    host, port = server.server_address[:2]
    print(f"tuning service listening on http://{host}:{port} "
          f"(db={args.db or '<memory>'}, "
          f"{len(service.db.fingerprints())} entries; "
          f"GET /metrics for Prometheus text)", flush=True)
    try:
        import threading

        threading.Event().wait()  # serve_forever runs on a daemon thread
    except KeyboardInterrupt:
        server.shutdown()


def make_client(args: argparse.Namespace):
    """A ServiceClient over HTTP, optionally behind the fault injector."""
    from repro_torch.fleet import FaultInjectionTransport, HTTPTransport, ServiceClient

    transport = HTTPTransport(args.service_url, timeout_s=args.timeout)
    injector = None
    if args.fault_seed is not None:
        injector = FaultInjectionTransport(
            transport, seed=args.fault_seed,
            drop_request=args.fault_drop, drop_response=args.fault_drop,
            duplicate=args.fault_dup, reorder=args.fault_reorder,
        )
        transport = injector
    client = ServiceClient(transport, retries=args.retries,
                           jitter_seed=args.host_index)
    return client, injector


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--kernel", default="demo",
        help="'demo' (analytic, spawn-safe) or a registered kernel name",
    )
    ap.add_argument(
        "--device", default="cuda",
        help="where a kernel's example inputs live (default: the CUDA card; "
             "cpu on request)",
    )
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--shard-policy", choices=("stride", "block"), default="stride")
    ap.add_argument("--backend", choices=("thread", "spawn", "remote"),
                    default="thread")
    ap.add_argument(
        "--sync-every", type=int, default=8,
        help="trials between scratch-DB syncs (0 = merge barrier only)",
    )
    ap.add_argument("--db", default=None, help="persistent TuningDB path")
    ap.add_argument("--scratch-dir", default=None,
                    help="directory for per-worker scratch DBs")
    ap.add_argument("--keep-scratch", action="store_true",
                    help="leave scratch files on disk after the barrier")
    ap.add_argument(
        "--no-device-key", action="store_true",
        help="do not namespace DB entries under the device's DeviceFingerprint",
    )
    ap.add_argument(
        "--check-equivalence", action="store_true",
        help="re-run with one worker and demand the same winner (demo only: "
             "measured costs carry noise)",
    )
    # -- global tuning service ------------------------------------------------
    ap.add_argument("--serve-db", action="store_true",
                    help="run the global tuning service (uses --db/--host/--port)")
    ap.add_argument("--host", default="127.0.0.1", help="--serve-db bind host")
    ap.add_argument("--port", type=int, default=0,
                    help="--serve-db bind port (0 = ephemeral)")
    ap.add_argument("--service-url", default=None,
                    help="global tuning service URL (http://host:port)")
    ap.add_argument("--hosts", type=int, default=1,
                    help="total hosts sharing the space through the service")
    ap.add_argument("--host-index", type=int, default=0,
                    help="this host's slice index in [0, --hosts)")
    ap.add_argument("--timeout", type=float, default=5.0,
                    help="per-request service timeout (seconds)")
    ap.add_argument("--retries", type=int, default=5,
                    help="service retries per call (bounded backoff)")
    # -- deterministic fault injection ----------------------------------------
    ap.add_argument("--fault-seed", type=int, default=None,
                    help="enable the fault injector with this RNG seed")
    ap.add_argument("--fault-drop", type=float, default=0.0,
                    help="per-call drop probability (requests and responses)")
    ap.add_argument("--fault-dup", type=float, default=0.0,
                    help="per-call duplicate-delivery probability")
    ap.add_argument("--fault-reorder", type=float, default=0.0,
                    help="per-call hold-and-replay (reorder) probability")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the run's worker/client/fault metrics as "
                         "Prometheus text to PATH")
    args = ap.parse_args()

    if args.serve_db:
        serve(args)
        return

    if args.kernel != "demo":
        if args.backend == "spawn":
            ap.error("--backend spawn requires --kernel demo "
                     "(measured kernel costs close over CUDA tensors)")
        if args.check_equivalence:
            ap.error("--check-equivalence requires --kernel demo (a measured "
                     "winner is not the same point twice on a card)")

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device (torch.cuda.is_available() is false); "
                 "pass --device cpu to tune on the CPU")

    from repro_torch.core import BasicParams, TuningDB
    from repro_torch.fleet import FleetCoordinator, device_bp_entries, local_device
    from repro_torch.fleet.workloads import demo_cost, demo_space, kernel_problem

    if args.kernel == "demo":
        space, cost = demo_space(), demo_cost
    else:
        _, space, cost = kernel_problem(args.kernel, device)

    client, injector = (None, None)
    if args.service_url:
        client, injector = make_client(args)
    elif args.backend == "remote":
        ap.error("--backend remote requires --service-url")

    entries = {} if args.no_device_key else device_bp_entries(device)
    bp = BasicParams.make(kernel=f"fleet/{args.kernel}", **entries)
    db = TuningDB(args.db) if args.db else None

    coordinator = FleetCoordinator(
        workers=args.workers,
        shard_policy=args.shard_policy,
        backend=args.backend,
        sync_every=args.sync_every,
        scratch_dir=args.scratch_dir,
        service=client,
        hosts=args.hosts,
        host_index=args.host_index,
        keep_scratch=args.keep_scratch,
    )
    fleet = coordinator.search(space, cost, bp=bp, db=db)

    print(f"device: {'-' if args.no_device_key else local_device(device).label}")
    print(f"space: {space.size()} candidates, {len(fleet.workers)} workers "
          f"({args.backend}/{args.shard_policy}, sync_every={args.sync_every})")
    if args.hosts > 1:
        print(f"host {args.host_index}/{args.hosts}: this process measured "
              f"its slice only; the service holds the union")

    # worker/client/fault stats all flow through the one registry pipe —
    # the printed report and --metrics-out render the same source of truth
    from repro_torch.obs import MetricsRegistry

    registry = MetricsRegistry()
    for w in fleet.workers:
        registry.register_stats(
            "fleet_worker", w, help="per-worker shard stats", worker=w.worker
        )
    if client is not None:
        registry.register_stats(
            "service_client", client.stats, help="service-client stats"
        )
        registry.gauge(
            "service_client_degraded", help="1 = merge barrier ran local-only"
        ).set(0 if fleet.service_synced else 1)
    if injector is not None:
        registry.register_stats(
            "fault_injector", injector.stats, help="injected transport faults"
        )
    print(registry.report(title="fleet metrics"))
    print(f"fleet winner: {json.dumps(fleet.best.point, sort_keys=True)} "
          f"@ {fleet.best.cost:.3e} ({fleet.evaluations} total evaluations)")
    if client is not None and not fleet.service_synced:
        print("WARNING: service DEGRADED — merge barrier ran local-only")
    if args.metrics_out:
        registry.write(args.metrics_out)
        print(f"metrics written to {args.metrics_out}")

    if args.check_equivalence:
        single = FleetCoordinator(
            workers=1, shard_policy=args.shard_policy, backend="thread",
            sync_every=0,
        ).search(space, cost, bp=bp)
        if single.best.point != fleet.best.point:
            raise SystemExit(
                f"FLEET EQUIVALENCE VIOLATED: {args.workers}-worker winner "
                f"{fleet.best.point} != single-process winner {single.best.point}"
            )
        scope = ("fleet-union" if args.hosts > 1 else f"{args.workers}-worker")
        print(f"equivalence OK: {scope} winner == single-process winner")

    if args.db:
        print(f"tuning DB: {args.db} "
              f"({len(fleet.merged.fingerprints())} entries)")


if __name__ == "__main__":
    main()
