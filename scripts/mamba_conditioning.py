#!/usr/bin/env python3
"""How falcon-mamba-7b's random weights carry bf16 rounding into its
logits, on the port's plain route: the readings behind ``chip_smoke.py``'s
``temper(..., ssm=True)`` and its decode-after-prefill witness.

    PYTHONPATH=src python3 scripts/mamba_conditioning.py [--out FILE] [--small]

Two parts, on the CPU (CPU tensors take the plain versions):

* decode after prefill at the published width (d_model 4096, d_inner
  8192, the full vocabulary) cut to 2 layers, JAX init, seeds 0-3, a
  512-token prompt and one step against prefill of 513 tokens: the largest
  gap in bf16 and on float32 weights of the same values, each beside
  ``tests/test_models.py``'s rule (rtol 0.1, atol 0.08);
* at width 1024 (d_inner 2048), the full vocabulary, 2 and 64 layers, a
  128-token prompt: the last logits' worst row ``‖bf16 − f32‖ / ‖f32‖``
  at the JAX init and tempered, and with the blocks tempered how far the
  blocks move the logits (the worst row against the same model with every
  out_proj zeroed).

Prints one line a reading and one JSON line, which ``--out`` also
receives.  ``--small`` runs both parts at width 256, 2 and 4 layers and a
512-token vocabulary: a check of the script itself.  The full run holds
~3 GB and takes ~2 min on 8 CPU cores.
"""
from __future__ import annotations

import argparse
import copy
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402


def worst_row(got, ref) -> float:
    got, ref = got.float(), ref.float()
    return float(((got - ref).norm(dim=-1) / ref.norm(dim=-1)).max())


def decode_after_prefill(params, cfg, tokens) -> tuple:
    """(the largest |step − full|, within the rule) for prompt[:-1] and one
    decode step against prefill of the whole prompt."""
    full, _ = tm.prefill_fn(params, {"tokens": tokens}, cfg)
    _, short = tm.prefill_fn(params, {"tokens": tokens[:, :-1]}, cfg,
                             capacity=tokens.shape[1])
    step, _ = tm.decode_fn(params, {"tokens": tokens[:, -1:]}, short, cfg)
    step, full = step.float(), full.float()
    gap = (step - full).abs()
    return float(gap.max()), bool((gap <= 0.08 + 0.1 * full.abs()).all())


def zeroed_blocks(params):
    out = copy.deepcopy(params)
    with torch.no_grad():
        for m in out.modules():
            if isinstance(m, tm.Params) and "A_log" in m:
                m["out_proj"].zero_()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON line here")
    ap.add_argument("--small", action="store_true", help="a small check of the script")
    args = ap.parse_args()
    base = get_config("falcon-mamba-7b")
    if args.small:
        wide, narrow = dict(d_model=256, vocab_size=512), dict(d_model=256, vocab_size=512)
        seeds, depths, seq = (0, 1), (2, 4), (32, 16)
    else:
        wide, narrow = {}, dict(d_model=1024)
        seeds, depths, seq = (0, 1, 2, 3), (2, 64), (512, 128)
    out = {"decode_after_prefill": [], "conditioning": []}

    cfg = base.with_(n_layers=2, **wide)
    for seed in seeds:
        params = tm.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
        tokens = torch.randint(0, cfg.vocab_size - 1, (1, seq[0] + 1),
                               generator=torch.Generator().manual_seed(seed))
        bf16 = decode_after_prefill(params, cfg, tokens)
        f32 = decode_after_prefill(copy.deepcopy(params).float(), cfg, tokens)
        row = {"seed": seed, "d_model": cfg.d_model, "bf16_max_abs": bf16[0],
               "bf16_within": bf16[1], "f32_max_abs": f32[0], "f32_within": f32[1]}
        print(f"decode after prefill, {cfg.n_layers} layers at width {cfg.d_model}, seed "
              f"{seed}: bf16 {bf16[0]:.4g} (within the rule: {bf16[1]}), float32 weights "
              f"{f32[0]:.4g} (within: {f32[1]})", flush=True)
        out["decode_after_prefill"].append(row)

    for depth in depths:
        cfg = base.with_(n_layers=depth, **narrow)
        tokens = torch.randint(0, cfg.vocab_size - 1, (1, seq[1]),
                               generator=torch.Generator().manual_seed(1))
        for ssm in (False, True):
            params = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
            chip_smoke.temper(torch, tm, params, ssm=ssm)
            bf16, _ = tm.prefill_fn(params, {"tokens": tokens}, cfg)
            f32, _ = tm.prefill_fn(copy.deepcopy(params).float(), {"tokens": tokens}, cfg)
            row = {"n_layers": depth, "d_model": cfg.d_model, "tempered": ssm,
                   "bf16_vs_f32_worst_row": worst_row(bf16, f32)}
            if ssm:
                bare, _ = tm.prefill_fn(zeroed_blocks(params).float(), {"tokens": tokens}, cfg)
                row["blocks_move_logits_worst_row"] = worst_row(bare, f32)
            print(f"{depth} layers at width {cfg.d_model}, "
                  f"{'tempered' if ssm else 'JAX init'}: bf16 vs float32 last logits worst row "
                  f"{row['bf16_vs_f32_worst_row']:.4g}"
                  + (f"; the blocks move them by {row['blocks_move_logits_worst_row']:.4g}"
                     if ssm else ""), flush=True)
            out["conditioning"].append(row)
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
