"""The float32 flash attention kernel (3xTF32 on the tensor cores), as far
as the CPU can see it.

The kernel (``csrc/flash_attention.cu``: ``mma.sync`` m16n8k8 TF32, a
``cp.async`` ring) runs only on the card, where ``chip_smoke.py`` holds
every emitted point against the plain version.  Here: the emitted float32
space is exactly the instantiated tile table and the table is the
source's; the hint charges float32 at a third of the TF32 rate, which the
ArchSpec carries for each H100 part; and a CPU emulation of the kernel's
arithmetic (every product split into a TF32 high part and the rest, three
TF32 products) stays within ``DEFAULT_TOL`` float32 of the JAX kernel
(Pallas in interpret mode), where one TF32 product does not: the reason
for three.
"""
from __future__ import annotations

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformance import DEFAULT_TOL
from repro.kernels.flash_attention import ops as jax_fa_ops
from repro_torch import carry
from repro_torch.core import pp_key
from repro_torch.core.arch import ArchSpec, from_properties
from repro_torch.kernels.flash_attention import flash_attention as fa_mod
from repro_torch.kernels.flash_attention import ops as fa_ops
from test_torch_arch import props
from test_torch_kernels import assert_close, qkv_numpy

SXM = from_properties(props("NVIDIA H100 80GB HBM3"))
SOURCE = Path(fa_mod.__file__).resolve().parents[2] / "csrc" / "flash_attention.cu"


def test_python_tile_table_is_the_sources():
    """F32_TILES lists exactly the FLASH_F32_TILES instantiations."""
    text = SOURCE.read_text()
    body = text[text.index("#define FLASH_F32_TILES(X)"):]
    body = body[: body.index("\n\n")]
    tiles = {tuple(map(int, t)) for t in re.findall(r"X\((\d+), (\d+), (\d+)\)", body)}
    assert tiles == set(fa_mod.F32_TILES)
    assert len(tiles) == 23
    assert max(bkv for hd, _, bkv in tiles if hd == 128) == 64
    assert {(bq, bkv) for hd, bq, bkv in tiles if hd == 256} == {(64, 32)}


def test_f32_source_is_the_tensor_core_kernel():
    text = SOURCE.read_text()
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in text
    assert "cp.async.cg.shared.global" in text
    for banned in ("scaled_dot_product_attention", "cublas", "cudnn", "wmma::"):
        assert banned not in text.lower()


@pytest.mark.parametrize("S,hd", [(2048, 64), (2000, 64), (2048, 128), (256, 16), (256, 32)])
def test_f32_space_is_the_tile_table(S, hd):
    region = fa_ops.flash_region(S, hd, "float32", arch=SXM, heads=32)
    points = {(p["block_q"], p["block_kv"]) for p in region.space.points()}
    assert points == {(bq, bkv) for h, bq, bkv in fa_mod.F32_TILES if h == hd}


def test_short_sequences_keep_instantiated_f32_tiles():
    region = fa_ops.flash_region(50, 64, "float32", arch=SXM)
    assert {(p["block_q"], p["block_kv"]) for p in region.space.points()} == {(64, 32), (64, 64)}


def test_every_f32_tile_fits_and_its_smem_is_the_kernels_layout():
    """The q tile and two stages of k and v, rows padded by 8, 8 and 4 floats."""
    for hd, bq, bkv in fa_mod.F32_TILES:
        smem = fa_mod.smem_bytes(bq, bkv, hd, 4)
        assert smem == 4 * (bq * (hd + 8) + 2 * bkv * ((hd + 8) + (hd + 4)))
        assert smem <= SXM.smem_per_block
    assert fa_mod.smem_bytes(128, 128, 128, 4) > SXM.smem_per_block  # why hd 128 stops at 64


@pytest.mark.parametrize("name,tf32", [("NVIDIA H100 80GB HBM3", 495e12),
                                       ("NVIDIA H100 PCIe", 378e12),
                                       ("NVIDIA H100 NVL", 417.5e12),
                                       ("NVIDIA H200", 495e12)])
def test_arch_carries_the_tf32_rate(name, tf32):
    arch = from_properties(props(name))
    assert arch.peak_flops_tf32 == tf32
    assert ArchSpec.from_bp_entries(arch.bp_entries()) == arch


@pytest.mark.parametrize("name", ["NVIDIA H100 80GB HBM3", "NVIDIA H100 PCIe"])
def test_hint_charges_f32_at_a_third_of_the_tf32_rate(name):
    arch = from_properties(props(name))
    assert fa_ops.FLASH_POLICY.flop_rate(arch, {"dtype": "float32"}) == arch.peak_flops_tf32 / 3
    assert fa_ops.FLASH_POLICY.flop_rate(arch, {"dtype": "bfloat16"}) == arch.peak_flops
    region = fa_ops.flash_region(2048, 64, "float32", arch=arch, heads=32)
    for p in region.space.points():
        hint = region.hints[pp_key(p)]
        fill = min(1.0, hint["programs"] / arch.sm_count)
        est = (hint["waves"] * arch.wave_overhead_s
               + max(hint["flops"] / (arch.peak_flops_tf32 / 3 * fill),
                     hint["bytes"] / (arch.hbm_bandwidth * fill)))
        assert hint["est_s"] == pytest.approx(est, rel=1e-12)
        assert hint["flops"] / (arch.peak_flops_tf32 / 3) > hint["bytes"] / arch.hbm_bandwidth


# -- the kernel's arithmetic, emulated on the CPU -----------------------------

def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (to nearest on the low 13 bits, ties away), as the
    kernel rounds a product's high part."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """The top 19 bits, which the tensor core reads of any float32."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def matmul_tf32(a: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """a @ b in float32 from TF32 products: three (lo.hi + hi.lo + hi.hi,
    small terms first, lo truncated by the tensor core) or one (hi.hi)."""
    ah, bh = tf32_round(a), tf32_round(b)
    if terms == 1:
        return ah @ bh
    al, bl = tf32_truncate(a - ah), tf32_truncate(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def attention_tf32(q, k, v, terms: int) -> torch.Tensor:
    """Causal GQA attention with both products in TF32 terms; the softmax in
    float32.  q (B,S,H,hd), k/v (B,S,KV,hd)."""
    B, S, H, hd = q.shape
    rep = H // k.shape[2]
    qh = q.permute(0, 2, 1, 3)
    kh = k.permute(0, 2, 1, 3).repeat_interleave(rep, dim=1)
    vh = v.permute(0, 2, 1, 3).repeat_interleave(rep, dim=1)
    s = matmul_tf32(qh, kh.transpose(-1, -2), terms) / math.sqrt(hd)
    s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1), -0.7 * torch.finfo(torch.float32).max)
    p = torch.softmax(s, dim=-1)
    return matmul_tf32(p, vh, terms).permute(0, 2, 1, 3)


def test_tf32_rounding_keeps_19_bits():
    x = torch.tensor([1.0 + 2.0**-10, 1.0 + 2.0**-11, 1.0 + 2.0**-12, -(1.0 + 3 * 2.0**-12)])
    assert tf32_round(x).tolist() == [1.0 + 2.0**-10, 1.0 + 2.0**-10, 1.0, -(1.0 + 2.0**-10)]
    assert tf32_truncate(x).tolist() == [1.0 + 2.0**-10, 1.0, 1.0, -1.0]
    y = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    hi = tf32_round(y)
    assert torch.equal(tf32_round(hi), hi)
    assert float(((y - hi).abs() / y.abs()).max()) <= 2.0**-11


@pytest.mark.parametrize("seed", [50, 51])
def test_three_tf32_products_hold_the_f32_tolerance_and_one_does_not(seed):
    """S=256, hd 64, DEFAULT_TOL float32 (2e-4, 1e-5) against the JAX kernel."""
    q, k, v = qkv_numpy(seed=seed, S=256, H=2, KV=1, hd=64)
    ref = np.asarray(jax_fa_ops.attention(*(jnp.asarray(a) for a in (q, k, v)),
                                          block_q=64, block_kv=64), np.float32)
    qt, kt, vt = carry.attention_inputs(q, k, v, device="cpu")
    three = attention_tf32(qt, kt, vt, terms=3)
    assert_close(three, ref, "float32", f"3xTF32 seed {seed}")
    one = carry.to_numpy(attention_tf32(qt, kt, vt, terms=1))
    rtol, atol = DEFAULT_TOL["float32"]
    assert not np.allclose(one, ref, rtol=rtol, atol=atol)
    # the three-term error is two orders below the one-term error
    assert np.abs(carry.to_numpy(three) - ref).max() * 100 < np.abs(one - ref).max()
