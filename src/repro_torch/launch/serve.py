"""Serve CLI of the port, on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b

The counterpart of ``repro.launch.serve``, with the same flags; the
weights are the port's ``init_params`` drawn from a ``torch.Generator``
seeded 0 on ``--device`` (``cuda`` unless asked for ``cpu``).

Fleet flags: ``--device-key`` namespaces DB entries under the card's
DeviceFingerprint, ``--drift-factor`` turns on the static Server's drift
watch (its re-tunes run on the background tuner), and ``--fleet-workers``
shards each background search across that many in-process workers.

``--trace mixed`` replays a mixed prefill/decode trace through the
traffic-class autotuner: unseen classes tune on the
background worker while the hot path serves the precompiled default, then
hot-swap to the tuned winner.  ``--inline-tune`` instead tunes on the hot
path (the latency-comparison baseline); the default performs no tuning.

``--stream`` swaps the static batch Server for the continuous-batching
:class:`~repro_torch.runtime.engine.StreamingEngine`: an open-loop bursty arrival
trace feeds an admission queue, the iteration-level scheduler interleaves
prefill and decode over a paged KV cache, and the report adds TTFT
percentiles (the metric static batching loses under bursty load).

Overload/chaos knobs (stream mode): ``--deadline`` sets a
per-request TTL, ``--queue-limit``/``--shed-policy`` bound the admission
queue, and ``--chaos-seed`` runs the trace under the seeded
:class:`~repro_torch.runtime.chaos.ChaosInjector` (transient step faults, KV
squeezes, delays) on the adversarial trace.  The run exits non-zero if the
hardened engine fails to retire every request exactly once (the drain
contract).
"""
import argparse
import sys


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument(
        "--batch-size", type=int, default=None,
        help="serve batch width (default: min(4, requests))",
    )
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--full", action="store_true")
    ap.add_argument(
        "--device", default="cuda",
        help="where the model runs (default: the CUDA card; cpu on request)",
    )
    ap.add_argument(
        "--trace", choices=("uniform", "mixed", "bursty"), default="uniform",
        help="uniform: identical requests; mixed: prefill/decode-heavy mix; "
             "bursty: the mixed mix with open-loop burst arrivals "
             "(--stream's default)",
    )
    ap.add_argument(
        "--stream", action="store_true",
        help="serve with the continuous-batching StreamingEngine "
             "(admission queue + paged KV cache + tuned scheduler knobs) "
             "instead of the static-batch Server",
    )
    ap.add_argument(
        "--blocks", type=int, default=8,
        help="paged KV cache pool size (stream mode): max concurrent "
             "in-flight requests",
    )
    ap.add_argument(
        "--max-len", type=int, default=None,
        help="per-request KV capacity (stream mode); default: sized to the "
             "longest prompt+completion in the trace",
    )
    ap.add_argument(
        "--burst-size", type=int, default=4,
        help="requests per arrival burst (bursty trace)",
    )
    ap.add_argument(
        "--burst-gap", type=float, default=0.05,
        help="virtual seconds between bursts (bursty trace)",
    )
    ap.add_argument(
        "--deadline", type=float, default=None,
        help="per-request TTL in virtual seconds (stream mode): a request "
             "not finished within this of its arrival retires timed_out",
    )
    ap.add_argument(
        "--queue-limit", type=int, default=None,
        help="admission queue bound (stream mode): excess waiting requests "
             "are shed per --shed-policy",
    )
    ap.add_argument(
        "--shed-policy", default=None,
        choices=("reject-new", "drop-oldest", "deadline-aware"),
        help="load-shedding policy when the queue exceeds --queue-limit "
             "(default: let the tuned scheduler knob pick)",
    )
    ap.add_argument(
        "--chaos-seed", type=int, default=None,
        help="run under the seeded ChaosInjector (stream mode): transient "
             "step faults, KV-pool squeezes, and virtual delays; the trace "
             "switches to the adversarial variant (deadlines + priorities)",
    )
    ap.add_argument(
        "--chaos-fault-rate", type=float, default=0.05,
        help="per-step transient fault probability under --chaos-seed",
    )
    ap.add_argument(
        "--unhardened", action="store_true",
        help="disable the engine's hardened paths (strict upfront "
             "validation, raise-on-stall) — the crash/deadlock baseline",
    )
    ap.add_argument(
        "--trace-out", default=None, metavar="PATH",
        help="write a Chrome/Perfetto trace of the run (tuner trials, "
             "background jobs, engine request timelines on the virtual "
             "clock) to PATH; view at ui.perfetto.dev",
    )
    ap.add_argument(
        "--metrics-out", default=None, metavar="PATH",
        help="write the run's metrics registry (engine/server, chaos, "
             "background-tuner stats) as Prometheus text to PATH",
    )
    ap.add_argument(
        "--tick-timer", type=float, default=None, metavar="SECONDS",
        help="deterministic measurement clock (stream mode): every timed "
             "step costs exactly this many virtual seconds, so a seeded "
             "--chaos-seed run produces a byte-identical --trace-out",
    )
    tune_mode = ap.add_mutually_exclusive_group()
    tune_mode.add_argument(
        "--background-tune", action="store_true",
        help="tune unseen traffic classes on a background worker",
    )
    tune_mode.add_argument(
        "--inline-tune", action="store_true",
        help="tune unseen traffic classes on the hot path (baseline)",
    )
    tune_mode.add_argument(
        "--joint-tune", action="store_true",
        help="joint AT of (prefill x decode) degrees on the measured "
             "full serve step before serving",
    )
    ap.add_argument("--tuning-db", default=None, help="persistent TuningDB path")
    ap.add_argument(
        "--device-key", action="store_true",
        help="namespace DB entries under the card's DeviceFingerprint, so a "
             "fleet-shared DB never recalls another device's final",
    )
    ap.add_argument(
        "--drift-factor", type=float, default=None,
        help="enable the drift watch: demote + canary-re-tune a final whose "
             "observed cost exceeds its recorded cost by this factor "
             "(requires --background-tune: the re-tune must stay off the "
             "hot path)",
    )
    ap.add_argument(
        "--fleet-workers", type=int, default=None,
        help="shard background searches across N in-process fleet workers "
             "(requires --background-tune; on one card the workers time one "
             "at a time, so what they overlap is host work)",
    )
    args = ap.parse_args()
    if args.drift_factor and not args.background_tune:
        ap.error("--drift-factor requires --background-tune "
                 "(an inline re-tune would run the search on the hot path)")
    if args.fleet_workers and not args.background_tune:
        ap.error("--fleet-workers requires --background-tune "
                 "(there is no background search to shard without it)")
    if args.stream:
        if args.trace == "uniform":
            args.trace = "bursty"
        if args.joint_tune:
            ap.error("--joint-tune is a static-Server mode (the engine "
                     "tunes its scheduler knobs per traffic class instead)")
        if args.drift_factor:
            ap.error("--drift-factor is a static-Server mode")
    else:
        for flag, val in (("--deadline", args.deadline),
                          ("--queue-limit", args.queue_limit),
                          ("--shed-policy", args.shed_policy),
                          ("--chaos-seed", args.chaos_seed),
                          ("--tick-timer", args.tick_timer)):
            if val is not None:
                ap.error(f"{flag} requires --stream (the static Server has "
                         "no admission queue to bound)")

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import TuningDB
    from repro_torch.data import (
        adversarial_trace, bursty_open_loop_trace, mixed_traffic_trace,
        synthetic_requests,
    )
    from repro_torch.fleet import DriftMonitor, FleetCoordinator
    from repro_torch.models import init_params
    from repro_torch.obs import MetricsRegistry, TickTimer, Tracer, set_tracer
    from repro_torch.runtime import (
        BackgroundTuner, ChaosInjector, Server, StreamingEngine,
    )

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        # no fallback: serving on the CPU is asked for, never assumed
        sys.exit("no CUDA device (torch.cuda.is_available() is false); "
                 "pass --device cpu to serve on the CPU")

    tracer = Tracer() if args.trace_out else None
    if tracer is not None:
        # process-wide: tuner trials, search stages and background jobs
        # all land on the same flight recorder as the engine
        set_tracer(tracer)
    registry = MetricsRegistry() if args.metrics_out else None

    cfg = get_config(args.arch, smoke=not args.full)
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, gen, device)
    if args.stream and args.chaos_seed is not None:
        # the overload trace: the bursty mix plus deadlines and priorities,
        # so the hardened paths (timeout, shed, preempt) actually fire
        requests = adversarial_trace(
            cfg, args.requests, seed=args.chaos_seed,
            scale=1.0 if args.full else 0.25,
            burst_size=args.burst_size, burst_gap_s=args.burst_gap,
            deadline_ttl_s=args.deadline or 0.5,
        )
    elif args.trace == "bursty":
        # smoke configs get a scaled-down trace: full-length decodes dominate
        # a CI smoke run without exercising anything extra
        requests = bursty_open_loop_trace(
            cfg, args.requests, scale=1.0 if args.full else 0.25,
            burst_size=args.burst_size, burst_gap_s=args.burst_gap,
        )
    elif args.trace == "mixed":
        requests = mixed_traffic_trace(cfg, args.requests)
    else:
        requests = synthetic_requests(
            cfg, args.requests, args.prompt_len, args.new_tokens
        )

    fleet = (
        FleetCoordinator(workers=args.fleet_workers, backend="thread")
        if args.fleet_workers else None
    )
    tuner = BackgroundTuner(fleet=fleet) if args.background_tune else None

    if args.stream:
        max_len = args.max_len or max(
            len(r.prompt) + r.max_new_tokens for r in requests
        )
        chaos = (
            ChaosInjector(
                seed=args.chaos_seed,
                step_fault_rate=args.chaos_fault_rate,
                squeeze_rate=0.1,
                delay_rate=0.1,
            )
            if args.chaos_seed is not None else None
        )
        engine = StreamingEngine(
            cfg,
            params,
            n_blocks=args.blocks,
            max_len=max_len,
            tuning_db=TuningDB(args.tuning_db) if args.tuning_db else None,
            background_tuner=tuner,
            inline_tune=args.inline_tune,
            device_key=args.device_key,
            hardened=not args.unhardened,
            queue_limit=args.queue_limit,
            shed_policy=args.shed_policy,
            default_ttl_s=args.deadline,
            chaos=chaos,
            timer=TickTimer(args.tick_timer) if args.tick_timer else None,
            tracer=tracer,
        )
        out = engine.serve(requests)
        s = engine.stats
        print(
            f"served {len(out)} requests, {s.tokens_out} tokens, "
            f"{s.tok_per_s:.1f} tok/s "
            f"({s.prefill_steps} prefill / {s.decode_steps} decode steps, "
            f"peak in-flight {s.peak_in_flight})"
        )
        # every stat object flows through the one registry pipe — the
        # report below and --metrics-out render the same source of truth
        registry = registry or MetricsRegistry()
        registry.register_stats("engine", s, help="streaming-engine stats")
        if chaos is not None:
            registry.register_stats(
                "chaos", chaos.stats, help="chaos-injector stats"
            )

        def _retired(reg):
            for status in ("ok", "timed_out", "shed", "error"):
                n = sum(
                    1 for r in engine.results.values() if r.status == status
                )
                reg.gauge(
                    "engine_retired", help="terminal request statuses"
                ).set(n, status=status)

        registry.register_collector(_retired)
        print(registry.report(title="stream metrics"))
        if not args.unhardened:
            unique_rids = {r.rid for r in requests}
            if set(engine.results) != unique_rids:
                missing = sorted(unique_rids - set(engine.results))
                print(f"ERROR: drain incomplete — {len(missing)} requests "
                      f"never retired: {missing[:8]}")
                sys.exit(1)
        print(f"traffic classes: {', '.join(engine.traffic_classes_seen) or '-'}")
        print(f"hot-path tuning evaluations: {engine.hot_path_cost_evaluations}")
        if tuner is not None:
            drained = tuner.drain(timeout=300)
            tuner.stop()
            print(
                f"background-tuned classes: "
                f"{', '.join(tuner.tuned_labels) or '-'} "
                f"({tuner.background_evaluations} evaluations off the hot path)"
            )
            sched = engine.tuned_scheduler_classes
            print(f"tuned scheduler classes: {', '.join(sched) or '-'}")
            if not drained:
                print("WARNING: background tuning did not drain within 300s")
            for label, err in tuner.errors:
                print(f"WARNING: background tuning failed for {label}: {err!r}")
        if args.metrics_out:
            registry.write(args.metrics_out)
            print(f"metrics written to {args.metrics_out}")
        if tracer is not None:
            set_tracer(None)
            tracer.write(args.trace_out)
            print(f"trace written to {args.trace_out} "
                  f"({tracer.emitted} events, {tracer.dropped} dropped)")
        return

    drift = (
        DriftMonitor(background=tuner, factor=args.drift_factor)
        if args.drift_factor else None
    )
    server = Server(
        cfg,
        params,
        batch_size=args.batch_size or min(4, args.requests),
        tuning_db=TuningDB(args.tuning_db) if args.tuning_db else None,
        background_tuner=tuner,
        inline_tune=args.inline_tune,
        device_key=args.device_key,
        drift_monitor=drift,
    )
    if args.joint_tune:
        r = server.joint_tune(requests)
        src = "recalled by fingerprint" if r.from_cache else (
            f"{r.evaluations} measured step evaluations"
        )
        print(f"joint serve winner: {r.assignment} ({src})")
    out = server.run(requests)
    print(f"served {len(out)} requests, {server.stats.tokens_out} tokens, "
          f"{server.stats.decode_tok_per_s:.1f} tok/s")
    print(f"traffic classes: {', '.join(server.traffic_classes_seen) or '-'}")
    print(f"hot-path tuning evaluations: {server.hot_path_cost_evaluations}")
    if tuner is not None:
        drained = tuner.drain(timeout=300)
        tuner.stop()
        print(f"background-tuned classes: {', '.join(tuner.tuned_labels) or '-'} "
              f"({tuner.background_evaluations} evaluations off the hot path)")
        if not drained:
            print("WARNING: background tuning did not drain within 300s")
        for label, err in tuner.errors:
            print(f"WARNING: background tuning failed for {label}: {err!r}")
    if drift is not None:
        kinds = ", ".join(kind for _, kind in drift.transitions)
        print(f"drift transitions: {len(drift.transitions)} ({kinds or '-'}); "
              f"{drift.checks} observations held against a recorded final")
        labels = {fp: st.traffic.label
                  for op in (server.prefill_op, server.decode_op)
                  for fp, st in op.states().items() if st.traffic is not None}
        by_class = ", ".join(f"{labels[fp]}={n}" for fp, n in sorted(
            drift.class_checks.items(), key=lambda kv: labels.get(kv[0], kv[0]))
            if fp in labels)
        print(f"drift checks by class: {by_class or '-'}")
    if args.metrics_out:
        registry = registry or MetricsRegistry()
        registry.register_stats(
            "server", server.stats, help="static-server stats"
        )
        registry.write(args.metrics_out)
        print(f"metrics written to {args.metrics_out}")
    if tracer is not None:
        set_tracer(None)
        tracer.write(args.trace_out)
        print(f"trace written to {args.trace_out} "
              f"({tracer.emitted} events, {tracer.dropped} dropped)")


if __name__ == "__main__":
    main()
