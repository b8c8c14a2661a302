"""The paper's GKV experiment (§III–§V) on the card.

    python examples/torch_autotune_gkv.py [--fast] [--db PATH]

Runs the joint (10 loop variants × degrees) before-execution AT of the GKV
``exb_realspcal`` loop nest at the paper's domain (iv=16, iz=16, mx=128,
my=65) on one CUDA card through the port (``repro_torch``), each
(variant, degree) a launch shape of the hand-written loop-nest kernel, and
prints the Fig. 11, 13 and 14 tables beside the paper's FX100 findings.
A degree is a CTA count: the paper's 1–32 and one, two and four CTAs an SM.
Run it twice: the second run recalls the tuned point from the DB with no
measurement.  ``--fast`` takes a smaller domain and fewer degrees.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.apps import degrees as app_degrees
from repro_torch.apps import gkv, paper_figures
from repro_torch.core import TuningDB, detect


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--db", default=os.path.join(tempfile.gettempdir(),
                                                 "torch_gkv_tuning.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_autotune_gkv: needs a CUDA card")
    device = torch.device("cuda:0")
    arch = detect(device)
    dims = (("iv", 8), ("iz", 8), ("mx", 32), ("my", 17)) if args.fast else gkv.GKV_DIMS
    degrees = (1, 32, arch.sm_count) if args.fast else app_degrees(arch)
    inputs = gkv.make_inputs(0, dims, device=device)
    nest = gkv.exb_nest(dims)
    print(f"{torch.cuda.get_device_name(device)}; domain {dict(dims)}; "
          f"{10 * len(degrees)} candidates; degrees {degrees}")

    point, _ = paper_figures.recall(nest, degrees, args.db, device)
    if point is not None:
        print(f"recalled from {args.db}: {point} (0 evaluations)")
        return

    f11 = paper_figures.fig11(nest, inputs, arch=arch)
    print(f"\nFig. 11: every variant at degree {paper_figures.FULL_DEGREE}")
    print(f"{'variant':26s}{'ms':>10s}{'launches':>10s}{'CTAs':>6s}{'vs orig':>9s}")
    for r in f11["rows"]:
        print(f"{r['figure']:26s}{r['s'] * 1e3:10.4f}{r['launches']:10d}{r['ctas']:6d}"
              f"{r['speedup']:9.3f}")
    print(f"best {f11['best']['figure']} {f11['best']['speedup']:.3f}x "
          f"(paper FX100: directive on outermost, {f11['paper']}x)")

    f13 = paper_figures.fig13_14(nest, inputs, degrees, TuningDB(args.db), arch=arch)
    print(f"\nFigs. 13-14: each variant at its best degree ({f13['evaluations']} evaluations, "
          f"{f13['tune_s']:.1f} s)")
    print(f"{'variant':26s}{'best ms':>10s}{'(deg)':>6s}{'vs orig':>9s}{'deg gain':>9s}")
    for r in f13["rows"]:
        print(f"{r['figure']:26s}{r['s'] * 1e3:10.4f}{r['best_degree']:6d}"
              f"{r['fig13']:9.3f}{r['fig14']:9.3f}")
    print(f"\ncombined best: {f13['best_point']} -> {f13['combined']:.3f}x vs original "
          f"(paper FX100: {f13['paper']['fig13']}x); innermost degree gain paper "
          f"{f13['paper']['fig14_innermost']}x")
    print(f"tuning DB: {args.db} (run again to recall)")


if __name__ == "__main__":
    main()
