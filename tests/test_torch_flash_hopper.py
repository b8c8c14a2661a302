"""The flash attention kernels for Hopper, as far as the CPU can see them.

The kernels (``csrc/flash_attention_sm90.cu``: bf16, wgmma, TMA ring;
``csrc/flash_attention.cu``: f32, 3xTF32 mma.sync) run only on the card,
where ``chip_smoke.py`` holds every emitted point against the plain
version.  Here: the bf16 space is exactly the instantiated tiles, the
float32 space is exactly its kernel's instantiated tiles, the hints count
B·H and charge each dtype's flops at the rate of the units that do them,
the shape class buckets B·H, and the plain versions agree with the JAX
kernel (Pallas in interpret mode) at the new tiles within ``DEFAULT_TOL``
(``tests/conformance.py``).
"""
from __future__ import annotations

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.core as tcore
from conformance import DEFAULT_TOL
from repro.kernels.flash_attention import ops as jax_fa_ops
from repro_torch import carry
from repro_torch.core import bucket_pow2, pp_key
from repro_torch.core.arch import from_properties
from repro_torch.kernels.flash_attention import flash_attention as fa_mod
from repro_torch.kernels.flash_attention import ops as fa_ops
from test_torch_arch import props
from test_torch_kernels import assert_close, qkv_numpy

SXM = from_properties(props("NVIDIA H100 80GB HBM3"))
SOURCE = Path(fa_mod.__file__).resolve().parents[2] / "csrc" / "flash_attention_sm90.cu"


def test_python_tile_table_is_the_sources():
    """SM90_TILES lists exactly the FLASH_SM90_TILES instantiations."""
    text = SOURCE.read_text()
    body = text[text.index("#define FLASH_SM90_TILES(X)"):]
    body = body[: body.index("\n\n")]
    tiles = {tuple(map(int, t)) for t in re.findall(r"X\((\d+), (\d+), (\d+)\)", body)}
    assert tiles == set(fa_mod.SM90_TILES)
    assert len(tiles) == 34
    assert max(bkv for hd, _, bkv in tiles if hd == 128) == 128
    assert max(bkv for hd, _, bkv in tiles if hd == 256) == 64


def test_bf16_source_is_the_tensor_core_kernel():
    text = SOURCE.read_text() + (SOURCE.parent / "hopper.cuh").read_text()
    assert "wgmma.mma_async" in text and "cp.async.bulk.tensor" in text
    for banned in ("scaled_dot_product_attention", "cublas", "cudnn"):
        assert banned not in text.lower()


@pytest.mark.parametrize("S,hd", [(2048, 64), (2000, 64), (2048, 128), (256, 16)])
def test_bf16_space_is_the_instantiated_set(S, hd):
    region = fa_ops.flash_region(S, hd, "bfloat16", arch=SXM, heads=32)
    points = {(p["block_q"], p["block_kv"]) for p in region.space.points()}
    assert points == {(bq, bkv) for h, bq, bkv in fa_mod.SM90_TILES if h == hd}
    for bq, bkv in points:
        assert (hd, bq, bkv) in fa_mod.SM90_TILES
        assert fa_mod.smem_bytes(bq, bkv, hd, 2) <= SXM.smem_per_block


@pytest.mark.parametrize("S,expected", [(50, {(64, 32), (64, 64)}),
                                        (100, {(64, 32), (64, 64), (64, 128),
                                               (128, 32), (128, 64), (128, 128)})])
def test_short_sequences_keep_instantiated_tiles(S, expected):
    """Below the largest tiles the ladder stops at the first power of two
    past S; it never falls back to the non-instantiated extent."""
    region = fa_ops.flash_region(S, 16, "bfloat16", arch=SXM)
    assert {(p["block_q"], p["block_kv"]) for p in region.space.points()} == expected


# The float32 space (S=2048, hd=64, SXM): the 3xTF32 kernel's instantiated
# tiles at hd 64, in the hint's order at B·H = 1 (one CTA row of q blocks:
# 64-row blocks fill more SMs) and at B·H = 32 (every point fills the card:
# 128-row blocks launch fewer waves).
F32_POINTS = {
    1: [(64, 32), (64, 64), (64, 128), (128, 128), (128, 32), (128, 64)],
    32: [(128, 128), (128, 32), (128, 64), (64, 32), (64, 64), (64, 128)],
}


@pytest.mark.parametrize("heads", [1, 32])
def test_f32_space_is_unchanged(heads):
    """The space is the instantiated set and no other (it replaced the
    CUDA-core kernel's 21 runtime tiles)."""
    region = fa_ops.flash_region(2048, 64, "float32", arch=SXM, heads=heads)
    points = [(p["block_q"], p["block_kv"]) for p in region.space.points()]
    assert set(points) == {(bq, bkv) for hd, bq, bkv in fa_mod.F32_TILES if hd == 64}
    assert points == F32_POINTS[heads]


def _hand_hint(arch, S, hd, heads, dtype, bq, bkv):
    """(programs, est_s) of one point, worked out from the kernel's loops."""
    keys = trips = longest = 0
    for q0 in range(0, S, bq):
        nkv = math.ceil(min(S, q0 + bq) / bkv)
        keys += nkv * bkv
        longest = max(longest, nkv)
        for w in range(bq // 64):  # blocks wholly above a warpgroup's rows are skipped
            trips += min(nkv, (q0 + 64 * w + 63) // bkv + 1)
    flops = heads * 4.0 * hd * bq * keys
    elt = 2 if dtype == "bfloat16" else 4
    bytes_ = heads * elt * (2.0 * S * hd + 2.0 * S * hd)  # K/V re-reads hit the L2
    if dtype == "bfloat16":
        rate = arch.peak_flops
        smem = 1024 + 2 * hd * (bq + 4 * bkv) + 64
        ctas = max(1, min((arch.smem_per_block + 1024) // (smem + 1024), 2048 // (2 * bq)))
        latency = fa_ops.TRIP_S * max(heads * trips / (arch.sm_count * ctas * bq // 64),
                                      longest)
    else:
        rate = arch.peak_flops_tf32 / 3  # 3xTF32: three TF32 products a multiply-add
        latency = 0.0
    pad = (math.ceil(S / bq) * bq / S) * (math.ceil(S / bkv) * bkv / S)
    programs = math.ceil(S / bq) * heads
    fill = min(1.0, programs / arch.sm_count)
    est = (math.ceil(programs / arch.sm_count) * arch.wave_overhead_s
           + max(flops * pad / (rate * fill), bytes_ * pad / (arch.hbm_bandwidth * fill),
                 latency))
    return programs, est


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("S,B,H", [(2048, 1, 32), (2000, 4, 32), (256, 1, 3)])
def test_hint_counts_heads_and_charges_the_right_units(dtype, S, B, H):
    """Without a card the bf16 residency is the shared-memory and thread
    bound; on the card CUDA's occupancy of the compiled tile."""
    heads = bucket_pow2(B * H)
    region = fa_ops.flash_region(S, 64, dtype, arch=SXM, heads=heads)
    for p in region.space.points():
        hint = region.hints[pp_key(p)]
        programs, est = _hand_hint(SXM, S, 64, heads, dtype, p["block_q"], p["block_kv"])
        assert hint["programs"] == math.ceil(S / p["block_q"]) * heads == programs
        assert hint["est_s"] == pytest.approx(est, rel=1e-12)
        assert (hint["latency_s"] > 0) == (dtype == "bfloat16")


def _bp(B, H, KV=1, S=64, dtype=torch.bfloat16):
    q = torch.empty(B, S, H, 16, dtype=dtype, device="meta")
    k = torch.empty(B, S, KV, 16, dtype=dtype, device="meta")
    return fa_ops.shape_class(q, k, k)


def test_shape_class_buckets_b_times_h():
    assert _bp(1, 32)["heads"] == 32 and _bp(1, 33)["heads"] == 64
    assert _bp(1, 32).fingerprint() != _bp(1, 33).fingerprint()
    assert _bp(1, 31).fingerprint() == _bp(1, 32).fingerprint()
    assert _bp(4, 8).fingerprint() == _bp(1, 32).fingerprint()  # B·H, not B or H


def test_two_head_buckets_tune_separately(tmp_path):
    path = str(tmp_path / "db.json")
    states = []
    for H in (2, 4):
        q, k, v = carry.attention_inputs(*qkv_numpy(seed=31 + H, S=64, H=H), device="cpu",
                                         dtype=torch.bfloat16)
        op = tcore.autotuned("flash_attention", db=tcore.TuningDB(path))
        op(q, k, v)
        states.append(op.resolve(q, k, v))
    assert all(s.cost_evaluations > 0 and not s.from_cache for s in states)
    assert states[0].bp.fingerprint() != states[1].bp.fingerprint()
    assert len(tcore.TuningDB(path).fingerprints()) == 2


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("S", [256, 200])
@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("point", [(64, 32), (64, 64), (128, 128)])
def test_plain_versions_match_jax_kernel_at_the_new_tiles(dtype, S, hd, point):
    """DEFAULT_TOL: float32 (2e-4, 1e-5), bfloat16 (2e-2, 2e-2)."""
    q, k, v = qkv_numpy(seed=40 + hd, S=S, H=2, KV=1, hd=hd)
    bq, bkv = point
    jdt = jnp.dtype(dtype)
    ref = jax_fa_ops.attention(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)), block_q=bq, block_kv=bkv
    )
    tdt = getattr(torch, dtype)
    out = fa_mod.flash_attention(*carry.attention_inputs(q, k, v, device="cpu", dtype=tdt),
                                 block_q=bq, block_kv=bkv)
    assert out.dtype == tdt and tuple(out.shape) == q.shape
    assert DEFAULT_TOL[dtype] == {"float32": (2e-4, 1e-5), "bfloat16": (2e-2, 2e-2)}[dtype]
    assert_close(out, ref, dtype, f"flash {dtype} S={S} hd={hd} {point}")
