"""Train CLI of the port, on the card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
        --steps 100 --ckpt-dir /tmp/run1 [--full]

The counterpart of ``repro.launch.train``, with the same flags and four
of its own: ``--device`` (``cuda``
unless asked for ``cpu``; no card and no ``--device cpu`` exits non-zero),
``--dtype`` (the parameters' dtype; AdamW's moments stay float32),
``--remat`` (``none``, ``full`` or ``dots``; the config's by default) and
``--seed`` (the weights' generator and the data stream).  Without
``--full`` the SMOKE config runs.

``--joint-tune`` runs whole-program joint AT before the loop: the
(microbatch degree × remat directive) composition is searched against the
measured full train step, the winner persists in the tuning DB under the
program fingerprint (``--tuning-db`` makes it survive runs) and
hot-applies through ``region.select``.
"""
import argparse
import sys


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--full", action="store_true", help="full (non-smoke) config")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument(
        "--joint-tune", action="store_true",
        help="joint AT of (microbatch degree x remat) on the measured step",
    )
    ap.add_argument(
        "--joint-cap", type=int, default=16,
        help="joint-candidate budget: products under the cap measure "
             "exhaustively, larger ones switch to coordinate descent "
             "(hard-stopped at 2x the cap, plus finals re-measurements)",
    )
    ap.add_argument(
        "--joint-k", type=int, default=None,
        help="per-member survivor count (default: the whole member space)",
    )
    ap.add_argument("--tuning-db", default=None, help="persistent TuningDB path")
    ap.add_argument(
        "--device-key", action="store_true",
        help="namespace DB entries (and the joint-program fingerprint) "
             "under the training device's DeviceFingerprint",
    )
    ap.add_argument(
        "--device", default="cuda",
        help="where the model trains (default: the CUDA card; cpu on request)",
    )
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16",
                    help="the parameters' dtype")
    ap.add_argument("--remat", choices=("none", "full", "dots"), default=None,
                    help="the remat directive (default: the config's)")
    ap.add_argument("--seed", type=int, default=0, help="weights and data stream")
    args = ap.parse_args()

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device (torch.cuda.is_available() is false); "
                 "pass --device cpu to train on the CPU")

    from repro_torch.configs import get_config
    from repro_torch.core import TuningDB
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import Trainer, TrainLoopConfig

    cfg = get_config(args.arch, smoke=not args.full)
    cfg = cfg.with_(dtype=args.dtype, remat=args.remat or cfg.remat)
    trainer = Trainer(
        cfg,
        AdamWConfig(total_steps=args.steps),
        TrainLoopConfig(
            total_steps=args.steps, ckpt_dir=args.ckpt_dir,
            n_microbatches=args.microbatches, seed=args.seed,
            joint_tune=args.joint_tune, joint_cap=args.joint_cap,
            joint_k=args.joint_k, device_key=args.device_key,
        ),
        tuning_db=TuningDB(args.tuning_db) if args.tuning_db else None,
        device=device,
    )
    ds = SyntheticLMDataset(cfg, global_batch=args.batch, seq_len=args.seq, seed=args.seed)
    hist = trainer.run(ds)
    print(f"final loss: {hist['loss'][-1]:.4f} after {len(hist['loss'])} steps")
    if trainer.joint_result is not None:
        r = trainer.joint_result
        src = "recalled by fingerprint" if r.from_cache else (
            f"{r.evaluations} measured step evaluations"
        )
        print(f"joint winner: {r.assignment} ({src})")


if __name__ == "__main__":
    main()
