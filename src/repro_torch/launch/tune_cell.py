"""Before-execution AT of a full training/serving cell through the FIBER
tuner: the paper's §IV procedure ("user fixes BP; measure all candidates;
persist; select") at 256-device scale with the hardware absent.

The port of ``repro.launch.tune_cell``, over the port's own ``Tuner``,
``ATRegion`` and ``TuningDB`` (schema v2):

BP  = (arch, shape, chips)
PP  = (sharding rule, remat policy, microbatch degree, attention blocks)
cost = the dry-run's three-term roofline of each candidate (max of C/M/X,
       :func:`~repro_torch.launch.dryrun.run_cell`'s trace), times a
       penalty where the step's per-device peak exceeds the card's memory
       (an H100's 80 GB, ``ArchSpec.hbm_bytes``).

    PYTHONPATH=src python -m repro_torch.launch.tune_cell --arch qwen2.5-32b \\
        --shape prefill_32k --db results/torch_cell_tuning.json
"""
from __future__ import annotations

import argparse
import json
from typing import Any, Dict, Mapping

from ..configs import ARCH_IDS, SHAPES, get_config
from ..core import ATRegion, BasicParams, ParamSpace, PerfParam, Tuner, TuningDB
from ..core.cost import roofline_from_trace
from .dryrun import H100_CLUSTER, lower_cell
from .mesh import make_production_mesh, n_chips

HBM_BYTES = H100_CLUSTER.hbm_bytes


def tune_cell(
    arch: str,
    shape: str,
    db_path: str,
    multi_pod: bool = False,
    hbm_penalty: float = 10.0,
) -> Dict[str, Any]:
    cell = SHAPES[shape]
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = n_chips(mesh)
    cfg = get_config(arch)

    params = [
        PerfParam("rule", ("tp",) + (("tp_ep",) if cfg.family == "moe" else ())
                  + (("tp_kvseq",) if cell.kind == "decode" else ())),
        PerfParam("attn_block_q", (512, 1024)),
        PerfParam("attn_block_kv", (1024, 4096)),
    ]
    if cell.kind == "train":
        params.append(PerfParam("remat", ("full", "dots")))
        params.append(PerfParam("n_micro", (1, 4)))
    space = ParamSpace(params)

    results: Dict[str, Any] = {}

    def cost(point: Mapping[str, Any]) -> float:
        overrides = {
            "attn_block_q": point["attn_block_q"],
            "attn_block_kv": point["attn_block_kv"],
        }
        if "remat" in point:
            overrides["remat"] = point["remat"]
        if cfg.family == "moe" and point["rule"] == "tp_ep":
            overrides["moe_groups"] = mesh.shape.get("data", 16)
        lowered, _ = lower_cell(
            arch, cell, mesh, point["rule"],
            cfg_overrides=overrides, n_micro=point.get("n_micro", 1),
        )
        traced = lowered.compile()
        mem = traced.memory()["per_device_total"]
        terms = roofline_from_trace(traced.trace, chips, H100_CLUSTER, mem)
        c = terms.total_s * (hbm_penalty if mem > HBM_BYTES else 1.0)
        results[json.dumps(dict(point), sort_keys=True)] = {
            "terms": terms.asdict(), "mem_per_dev": int(mem), "cost": c,
        }
        print(
            f"[tune] {dict(point)} -> C={terms.compute_s:.2e} M={terms.memory_s:.2e} "
            f"X={terms.collective_s:.2e} mem={mem / 2**30:.1f}GiB cost={c:.2e}"
        )
        return c

    region = ATRegion(f"{arch}/{shape}", space, instantiate=lambda p: (lambda: p))
    bp = BasicParams.make(arch=arch, shape=shape, chips=chips)
    tuner = Tuner(TuningDB(db_path))
    res = tuner.tune(region, bp, cost)
    print(f"\n[tune] best PP for BP({arch}, {shape}, {chips} chips): "
          f"{res.best.point}  cost={res.best.cost:.3e}s "
          f"({res.evaluations} candidates traced)")
    return {"best": res.best.point, "cost": res.best.cost, "all": results}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(ARCH_IDS))
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--db", default="results/torch_cell_tuning.json")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args()
    tune_cell(args.arch, args.shape, args.db, args.multi_pod)


if __name__ == "__main__":
    main()
