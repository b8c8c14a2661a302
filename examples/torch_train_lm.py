"""End-to-end training with the PyTorch port: a widened SMOKE LM for a few
hundred steps on the card, through the full training loop (checkpointing,
deterministic data, the microbatch degree as a registry op, straggler
monitoring).

    python3 examples/torch_train_lm.py --arch tinyllama-1.1b --steps 600

The counterpart of ``examples/train_lm.py``, run twice as long by default:
300 steps of the widened tinyllama SMOKE config took its loss down 15.4 %
on the CPU, 600 steps 33.0 % (``--device cpu``).  Loss must fall on the
synthetic-documents stream (structured bigrams): the script prints the
trajectory and the steps a second, and exits non-zero unless the mean of
the last 20 steps is at least 20 % below the mean of the first 20.  Causal attention runs on the hand-written flash kernels (forward
and backward); ``--device cpu`` runs their plain versions on the CPU
instead.
"""
import argparse
import os
import shutil
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.models import analytic_param_count
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import Trainer, TrainLoopConfig

MIN_DROP = 0.20  # the loss must fall by at least this fraction


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=list(ARCH_IDS))
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default="results/torch_train_lm_ckpt",
                    help="checkpoint directory ('' for none)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from an existing checkpoint dir (default: fresh)")
    ap.add_argument("--scale", type=float, default=2.0,
                    help="widen the smoke config by this factor")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (default: the CUDA card; cpu on request)")
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device; pass --device cpu to run on the CPU")

    base = get_config(args.arch, smoke=True)
    s = args.scale
    cfg = base.with_(
        d_model=int(base.d_model * s),
        d_ff=int(base.d_ff * s),
        n_layers=max(2, int(base.n_layers * min(s, 2))),
        vocab_size=base.vocab_size * 4,
    )
    print(f"model: {cfg.name} scaled -> {analytic_param_count(cfg) / 1e6:.1f}M params")
    if not args.resume and args.ckpt_dir and os.path.isdir(args.ckpt_dir):
        shutil.rmtree(args.ckpt_dir)  # fresh run unless --resume

    trainer = Trainer(
        cfg,
        AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=args.steps),
        TrainLoopConfig(
            total_steps=args.steps,
            ckpt_dir=args.ckpt_dir or None,
            save_every=max(50, args.steps // 4),
            n_microbatches=1,
            microbatch_candidates=(1, 2),
        ),
        device=device,
    )
    ds = SyntheticLMDataset(cfg, global_batch=args.batch, seq_len=args.seq)
    hist = trainer.run(ds)

    losses = hist["loss"]
    window = max(1, min(20, len(losses) // 4))
    first = float(np.mean(losses[:window]))
    last = float(np.mean(losses[-window:]))
    drop = 1 - last / first
    step_s = float(np.median(hist["step_time"]))
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU"
    print(f"\nsteps: {len(losses)}  loss {first:.3f} -> {last:.3f} "
          f"({drop * 100:.1f}% drop)")
    print(f"median step time: {step_s * 1e3:.1f} ms ({1 / step_s:.1f} steps/s on {name}); "
          f"stragglers flagged: {trainer.straggler_events}; restarts: {trainer.restarts}")
    for i in range(0, len(losses), max(1, len(losses) // 12)):
        print(f"  step {hist['step'][i]:4d}  loss {losses[i]:.4f}")
    if drop < MIN_DROP:
        sys.exit(f"loss did not drop >= {MIN_DROP:.0%} ({drop:.1%})")
    print("convergence check passed")


if __name__ == "__main__":
    main()
