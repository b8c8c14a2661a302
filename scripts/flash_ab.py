#!/usr/bin/env python3
"""Compare versions of the bf16 flash attention kernel on one CUDA card.

    python3 scripts/flash_ab.py <src dir> <label>

Builds the ``repro_torch`` package under ``<src dir>`` (a copy of ``src/``
whose ``csrc/flash_attention_sm90.cu`` may differ) into
``build/ab_<label>/``, holds every instantiated tile against the plain
version at small shapes (the bf16 row tolerance of ``chip_smoke.py``),
then times every tile at tinyllama-1.1b width (B=1 and B=4, S=2048,
32|4 heads, hd 64) and qwen3-0.6b width (B=1, S=2048, 16|8 heads, hd 128)
with ``chip_smoke.py``'s timer (L2 flushed, median of 10), and SDPA beside
the hd-64 cells.  Run it once per version in one call on the card, in
turns (A, B, B, A), and compare only within that call.
"""
from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(src: str, label: str) -> int:
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / f"ab_{label}")
    sys.path[:0] = [str(Path(src).resolve()), str(ROOT)]
    import torch
    import torch.nn.functional as F

    from chip_smoke import ROW_TOL, TOL, Timer, card_line, ptxas_entries
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention as fa, ref

    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device", file=sys.stderr)
        return 1
    print(card_line())
    t0 = time.perf_counter()
    _build.library("flash_attention_sm90")
    log = (_build.build_dir() / _build._digest() / "flash_attention_sm90.log").read_text()
    regs = sorted({r for r, _ in ptxas_entries(log).values()})
    spill = max(s for _, s in ptxas_entries(log).values())
    print(f"{label} build {time.perf_counter() - t0:.1f} s, registers {regs}, spill {spill} B")
    dev = torch.device("cuda")
    timer = Timer(torch, dev, 50 * 2**20)
    gen = torch.Generator(device=dev).manual_seed(0)
    rtol, atol = TOL["bfloat16"]
    bad = 0
    for B, S, H, KV, hd in ((1, 256, 2, 1, 16), (2, 200, 4, 2, 32), (1, 200, 2, 1, 128),
                            (1, 2000, 32, 4, 64)):
        q, k, v = ref.make_inputs(gen, B=B, S=S, H=H, KV=KV, hd=hd, dtype=torch.bfloat16,
                                  device=dev)
        r = fa.attention_plain(q, k, v).float()
        for h, bq, bkv in sorted(fa.SM90_TILES):
            if h != hd:
                continue
            o = fa.flash_attention_cuda(q, k, v, bq, bkv).float()
            diff = (o - r).abs()
            row = float((diff.norm(dim=-1) / r.norm(dim=-1)).max())
            if row > ROW_TOL["bfloat16"] or not bool((diff <= atol + rtol * r.abs()).all()):
                bad += 1
                print(f"{label} WRONG ({B},{S},{H}|{KV},{hd}) ({bq},{bkv}): row error {row}")
    print(f"{label} tiles off the plain version: {bad}")
    for B, S, H, KV, hd in ((1, 2048, 32, 4, 64), (4, 2048, 32, 4, 64), (1, 2048, 16, 8, 128)):
        q, k, v = ref.make_inputs(gen, B=B, S=S, H=H, KV=KV, hd=hd, dtype=torch.bfloat16,
                                  device=dev)
        times = {f"{bq},{bkv}": round(timer.ms(
            lambda: fa.flash_attention_cuda(q, k, v, bq, bkv)), 4)
            for h, bq, bkv in sorted(fa.SM90_TILES) if h == hd}
        print(f"{label} ({B},{S},{H}|{KV},{hd}) "
              + json.dumps(dict(sorted(times.items(), key=lambda kv: kv[1]))))
        if hd == 64:
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            sdpa = timer.ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True))
            print(f"{label} ({B},{S},{H}|{KV},{hd}) sdpa {sdpa:.4f}")
    return 1 if bad else 0


if __name__ == "__main__":
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1], sys.argv[2]))
