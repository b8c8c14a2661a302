"""§Perf hillclimb: hypothesis → change → re-trace → measure the
roofline on the three selected cells.

The port of ``repro.launch.hillclimb``, over the port's dry-run
(:func:`~repro_torch.launch.dryrun.run_cell`): the same experiments, with
the same labels and keyword arguments.  Each experiment is a named knob
assignment over the SAME cell; results are appended to
``results/torch_hillclimb.jsonl`` so the iteration log is reproducible.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell granite
    PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell all
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, List, Tuple

from ..configs import SHAPES
from ..optim import AdamWConfig
from .dryrun import mesh_name, run_cell

OUT = "results/torch_hillclimb.jsonl"

# (label, kwargs for run_cell) — ordered: each step keeps the previous step's
# winning knobs (coordinate descent along the dominant term).
EXPERIMENTS: Dict[str, Tuple[str, str, List[Tuple[str, Dict[str, Any]]]]] = {
    # The MoE dispatch: the JAX package's worst roofline fraction, collective-bound.
    "granite": (
        "granite-moe-1b-a400m",
        "train_4k",
        [
            ("baseline", dict(rule_name="tp")),
            ("ep_capacity_shard", dict(rule_name="tp_ep")),
            ("ep+remat_dots", dict(rule_name="tp_ep", cfg_overrides={"remat": "dots"})),
            ("ep+dots+micro4", dict(rule_name="tp_ep", cfg_overrides={"remat": "dots"}, n_micro=4)),
            ("ep+full+micro4", dict(rule_name="tp_ep", n_micro=4)),
            # it.2: GShard grouped dispatch — group boundaries = data shards,
            # every dispatch gather/scatter becomes shard-local
            ("ep+groups16", dict(rule_name="tp_ep", cfg_overrides={"moe_groups": 16})),
            ("ep+groups16+micro4", dict(rule_name="tp_ep", cfg_overrides={"moe_groups": 16}, n_micro=4)),
            # it.3: natively-batched dispatch with per-intermediate sharding
            # constraints (vmap left intermediate sharding to propagation)
            ("ep+groups16v2", dict(rule_name="tp_ep", cfg_overrides={"moe_groups": 16})),
            ("ep+groups16v3_lightconstraints", dict(rule_name="tp_ep", cfg_overrides={"moe_groups": 16})),
            ("ep+groups16v3+micro4", dict(rule_name="tp_ep", cfg_overrides={"moe_groups": 16}, n_micro=4)),
            ("final_vmap_groups16+micro4", dict(rule_name="tp_ep", cfg_overrides={"moe_groups": 16}, n_micro=4)),
            ("final_multipod", dict(rule_name="tp_ep", cfg_overrides={"moe_groups": 32}, n_micro=4, multi_pod=True)),
        ],
    ),
    # The JAX package's most collective-bound cell: scout MoE + wide attention.
    "scout": (
        "llama4-scout-17b-a16e",
        "train_4k",
        [
            ("baseline", dict(rule_name="tp")),
            ("ep_capacity_shard", dict(rule_name="tp_ep")),
            ("ep+groups16", dict(rule_name="tp_ep", cfg_overrides={"moe_groups": 16})),
            ("ep+groups16+micro8", dict(rule_name="tp_ep", cfg_overrides={"moe_groups": 16}, n_micro=8)),
            ("ep+groups16+dots", dict(rule_name="tp_ep", cfg_overrides={"moe_groups": 16, "remat": "dots"})),
            ("ep+groups16v2+micro8", dict(rule_name="tp_ep", cfg_overrides={"moe_groups": 16}, n_micro=8)),
            # attention block tuning against the memory term
            ("v2+micro8+blk1024x4096", dict(rule_name="tp_ep", cfg_overrides={"moe_groups": 16, "attn_block_q": 1024, "attn_block_kv": 4096}, n_micro=8)),
            # mesh refactorization: 40 heads % 16 != 0 -> attention replicated
            # on (16,16); (32,8) shards heads 8-ways and doubles data degree
            ("mesh32x8+groups32+micro4", dict(rule_name="tp_ep", cfg_overrides={"moe_groups": 32, "attn_block_q": 1024, "attn_block_kv": 4096}, n_micro=4, mesh_shape=(32, 8))),
            ("mesh32x8+dots+micro8", dict(rule_name="tp_ep", cfg_overrides={"moe_groups": 32, "attn_block_q": 1024, "attn_block_kv": 4096, "remat": "dots"}, n_micro=8, mesh_shape=(32, 8))),
        ],
    ),
    # Most representative of the paper's technique (flagship dense train).
    "llama3": (
        "llama3-405b",
        "train_4k",
        [
            ("baseline", dict(rule_name="tp")),
            ("remat_dots", dict(cfg_overrides={"remat": "dots"})),
            ("dots+micro8", dict(cfg_overrides={"remat": "dots"}, n_micro=8)),
            ("full+micro8", dict(n_micro=8)),
            ("full+micro8+fsdp", dict(rule_name="fsdp_tp", n_micro=8)),
            (
                "full+micro8+fsdp+bf16mom",
                dict(
                    rule_name="fsdp_tp",
                    n_micro=8,
                    opt_cfg=AdamWConfig(moment_dtype="bfloat16"),
                ),
            ),
            ("fsdp_fix_embed+micro8", dict(rule_name="fsdp_tp", n_micro=8)),
            (
                "final_multipod",
                dict(
                    rule_name="fsdp_tp",
                    n_micro=16,
                    opt_cfg=AdamWConfig(moment_dtype="bfloat16"),
                    multi_pod=True,
                ),
            ),
            # v2: keep weights TP-only across pods (no DCN weight gathers);
            # ZeRO over data handles optimizer memory; embed table fixed
            (
                "final_multipod_v2_tp",
                dict(
                    rule_name="tp",
                    n_micro=8,
                    opt_cfg=AdamWConfig(moment_dtype="bfloat16"),
                    multi_pod=True,
                ),
            ),
        ],
    ),
}



def run_experiments(cell_key: str, skip_done: bool = True) -> None:
    arch, shape, steps = EXPERIMENTS[cell_key]
    done = set()
    if skip_done and os.path.exists(OUT):
        with open(OUT) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    done.add((r["arch"], r["shape"], r.get("label", ""), r["mesh"]))
                except Exception:
                    pass
    for label, kwargs in steps:
        kwargs = dict(kwargs)
        multi_pod = kwargs.pop("multi_pod", False)
        name = mesh_name(multi_pod, kwargs.get("mesh_shape"))
        if (arch, shape, f"{cell_key}/{label}", name) in done:
            print(f"[hillclimb] skip {cell_key}/{label}")
            continue
        try:
            rec = run_cell(
                arch, SHAPES[shape], multi_pod=multi_pod,
                label=f"{cell_key}/{label}", **kwargs,
            )
        except Exception as e:
            rec = {
                "arch": arch, "shape": shape, "label": f"{cell_key}/{label}",
                "mesh": name, "status": "error",
                "error": f"{type(e).__name__}: {e}",
            }
            print(f"[hillclimb] FAIL {cell_key}/{label}: {e}")
        os.makedirs(os.path.dirname(OUT), exist_ok=True)
        with open(OUT, "a") as f:
            f.write(json.dumps(rec) + "\n")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", choices=list(EXPERIMENTS) + ["all"], default="all")
    args = ap.parse_args()
    cells = list(EXPERIMENTS) if args.cell == "all" else [args.cell]
    for c in cells:
        run_experiments(c)


if __name__ == "__main__":
    main()
