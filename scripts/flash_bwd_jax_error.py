#!/usr/bin/env python3
"""How far the JAX package's own flash backward is from the float32 answer
in bf16: the measure ``chip_smoke.py``'s bf16 gate on the port's backward
kernel is set beside.

    JAX_PLATFORMS=cpu PYTHONPATH=src python3 scripts/flash_bwd_jax_error.py

bf16 q, k, v, do (standard normal, from a numpy seed) go through JAX's
``_flash_forward_blocks`` and ``_flash_bwd`` (``src/repro/models/
attention.py``) in bf16, op by op and jitted, and the same values, taken
to float32, through the same functions in float32; the script prints each
gradient's max abs error and worst row ``‖g − r‖/‖r‖`` against the
float32 run (dq without query 0, whose exact gradient is zero), beside the
port's plain version (``attention_bwd_plain``) in bf16 against its float32
run.  Runs on the CPU; the numbers are JAX's arithmetic, not a device's.
"""
from __future__ import annotations

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models.attention import _flash_bwd, _flash_forward_blocks
from repro_torch.kernels.flash_attention.ref import attention_bwd_plain, attention_ref


def errors(got, ref) -> str:
    out = []
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        g, r = np.asarray(g, np.float32), np.asarray(r, np.float32)
        if name == "dq":
            g, r = g[:, 1:], r[:, 1:]
        rows = np.linalg.norm(g - r, axis=-1) / np.maximum(np.linalg.norm(r, axis=-1), 1e-30)
        out.append(f"{name} max abs {np.abs(g - r).max():.3e} worst row {rows.max():.3e}")
    return "; ".join(out)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--kv-heads", type=int, default=2)
    ap.add_argument("--head-dim", type=int, default=64)
    ap.add_argument("--block", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    S, H, KV, hd, blk = args.seq, args.heads, args.kv_heads, args.head_dim, args.block
    rng = np.random.default_rng(args.seed)
    arrays = [np.asarray(jnp.asarray(rng.standard_normal(s), jnp.bfloat16), np.float32)
              for s in ((1, S, H, hd), (1, S, KV, hd), (1, S, KV, hd), (1, S, H, hd))]

    def jax_bwd(dtype):
        q, k, v, do = (jnp.asarray(a, dtype) for a in arrays)
        o, lse = _flash_forward_blocks(q, k, v, blk, blk)
        return _flash_bwd(blk, blk, (q, k, v, o, lse), do)

    ref = jax.jit(lambda: jax_bwd(jnp.float32))()
    with jax.disable_jit():
        eager = jax_bwd(jnp.bfloat16)
    jitted = jax.jit(lambda: jax_bwd(jnp.bfloat16))()
    print(f"S={S} {H}|{KV} hd={hd} blocks {blk}, bf16 against float32 on the same values:")
    print(f"  JAX _flash_bwd op by op: {errors(eager, ref)}")
    print(f"  JAX _flash_bwd jitted:   {errors(jitted, ref)}")

    def port(dtype):
        q, k, v, do = (torch.from_numpy(a).to(dtype) for a in arrays)
        o, lse = attention_ref(q, k, v, return_lse=True)
        return [t.float().numpy() for t in attention_bwd_plain(q, k, v, o, lse, do)]

    print(f"  port attention_bwd_plain: {errors(port(torch.bfloat16), port(torch.float32))}")


if __name__ == "__main__":
    main()
