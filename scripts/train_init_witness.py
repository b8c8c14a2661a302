#!/usr/bin/env python3
"""Whether tinyllama-1.1b overfits one batch from the JAX init, on the
flash kernels and on their plain versions: a witness, beside
``chip_smoke.py``'s ``[train]`` overfit drill (which starts from tempered
wq, wk), that a model which does not learn from the JAX init fails for the
init, not for the kernels' gradient.

    PYTHONPATH=src python3 scripts/train_init_witness.py [--out FILE] [--device cpu]

On the card (the CUDA kernels build at first use) tinyllama-1.1b uncut,
bf16 parameters and float32 AdamW moments, takes 10 steps of
``make_train_step`` on the first batch of ``SyntheticLMDataset(seed 0)``
(B=4, S=4096, micro 4 and remat ``full``, so the plain attention's S×S
scores fit), four times: from the JAX init and from the same weights with
wq, wk tempered (``chip_smoke.temper``), each on the kernel route and
under ``plain_versions()``.  Prints every step's loss and gradient norm,
the largest loss gap between the two routes of each init, and one JSON
line, which ``--out`` also receives.  ``--device cpu`` runs the same at a
small size (2 layers, B=2, S=64, micro 2, 3 steps), where CPU tensors
take the plain versions on both routes: a check of the script itself.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
# the card's run (uncut) and the CPU's check of the script
SIZES = {"cuda": dict(layers=None, B=4, S=4096, micro=4, steps=10),
         "cpu": dict(layers=2, B=2, S=64, micro=2, steps=3)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    size = SIZES[args.device]

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("train_init_witness: no CUDA device (--device cpu checks the script)",
              file=sys.stderr)
        return 1
    from chip_smoke import SEED, temper
    from repro_torch import models as tm
    from repro_torch.configs import get_config
    from repro_torch.core import TuningDB
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.models import ServingRule, serving
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime.train import batch_tensors, make_train_step
    from repro_torch.tree import as_tree

    if args.device == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True)
        print(f"card: {card.stdout.strip() or 'unknown'}")
    device = torch.device("cuda:0" if args.device == "cuda" else "cpu")
    cfg = get_config("tinyllama-1.1b").with_(remat="full")
    if size["layers"]:
        cfg = cfg.with_(n_layers=size["layers"])
    opt = AdamWConfig(warmup_steps=4, total_steps=20)  # chip_smoke.py's [train] drill
    step = make_train_step(cfg, opt, size["micro"])
    batch = batch_tensors(SyntheticLMDataset(cfg, size["B"], size["S"], seed=SEED).batch(0),
                          device)
    rule = ServingRule(TuningDB(), inline_tune=True)
    runs = {}
    for init in ("jax", "tempered"):
        for route in ("kernels", "plain"):
            params = tm.init_params(cfg, torch.Generator(device=device).manual_seed(SEED),
                                    device)
            if init == "tempered":
                temper(torch, tm, params)
            params = as_tree(params)
            state = adamw_init(params, opt)
            losses, norms = [], []
            t0 = time.perf_counter()
            plain = tm.plain_versions() if route == "plain" else contextlib.nullcontext()
            with serving(rule), plain:
                for _ in range(size["steps"]):
                    params, state, metrics = step(params, state, batch)
                    losses.append(float(metrics["loss"]))
                    norms.append(float(metrics["grad_norm"]))
            seconds = time.perf_counter() - t0
            runs[f"{init} {route}"] = {"loss": losses, "grad_norm": norms, "s": seconds}
            print(f"[witness] {init} init, {route}: loss " + " ".join(f"{x:.4f}" for x in losses)
                  + "; grad norm " + " ".join(f"{x:.3f}" for x in norms) + f" ({seconds:.1f} s)")
            del params, state
            if device.type == "cuda":
                torch.cuda.empty_cache()
    gaps = {init: max(abs(a - b) for a, b in zip(runs[f"{init} kernels"]["loss"],
                                                  runs[f"{init} plain"]["loss"]))
            for init in ("jax", "tempered")}
    for init, gap in gaps.items():
        print(f"[witness] {init} init: the two routes' losses at most {gap:.4f} apart")
    line = json.dumps({"witness": {"arch": cfg.name, "layers": cfg.n_layers, **size,
                                   "remat": cfg.remat, "runs": runs, "route_gap": gaps}})
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
