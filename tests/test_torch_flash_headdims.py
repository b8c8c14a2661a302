"""Flash attention at every head dim the JAX kernel takes (1 to 256), as
far as the CPU can see it.

Both CUDA kernels run a call on the least instantiated tile head dim at or
above its ``hd`` and load the tile's columns past ``hd`` as zeros; they
run only on the card, where ``chip_smoke.py`` holds every emitted point at
hd 80 and 256 against the plain version.  Here: the port's plain version
against the JAX kernel (Pallas in interpret mode) at hd 80 and 256 within
``DEFAULT_TOL`` float32; the emitted space is exactly what
``launchable`` (the wrapper's check) takes; a head dim off the kernels'
16-byte rule runs padded to it (the plain version against the JAX kernel
at hd 12, 36 and 100, the emit layer offering the padded hd's points),
and one past 256 raises with the limit; and the rule is the sources'.
"""
from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

from repro.kernels.flash_attention import ops as jax_fa_ops
from repro_torch import carry
from repro_torch.core import pp_key
from repro_torch.core.arch import from_properties
from repro_torch.kernels.flash_attention import flash_attention as fa_mod
from repro_torch.kernels.flash_attention import ops as fa_ops
from test_torch_arch import props
from test_torch_kernels import assert_close, qkv_numpy

SXM = from_properties(props("NVIDIA H100 80GB HBM3"))
CSRC = Path(fa_mod.__file__).resolve().parents[2] / "csrc"
ELT = {"float32": 4, "bfloat16": 2}


@pytest.mark.parametrize("hd", [80, 256])
def test_plain_flash_matches_jax_kernel_at_head_dim(hd):
    q, k, v = qkv_numpy(seed=80 + hd, S=128, H=2, KV=1, hd=hd)
    ref = jax_fa_ops.attention(*(jnp.asarray(a) for a in (q, k, v)), block_q=64, block_kv=64)
    # the f32 kernel's only tile at hd 256 is (64, 32); hd 80 runs the hd-128 tiles
    out = fa_mod.flash_attention(*carry.attention_inputs(q, k, v, device="cpu"),
                                 block_q=64, block_kv=32)
    assert out.dtype == torch.float32 and tuple(out.shape) == q.shape
    assert_close(out, ref, "float32", f"flash f32 hd {hd}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [24, 80, 256])
def test_emitted_space_is_what_launches(hd, dtype):
    """Every emitted point passes ``launchable``, and every launchable tile
    whose shared memory fits the card is emitted."""
    region = fa_ops.flash_region(2048, hd, dtype, arch=SXM, heads=32)
    points = {(p["block_q"], p["block_kv"]) for p in region.space.points()}
    assert points and all(fa_mod.launchable(hd, dtype, bq, bkv) for bq, bkv in points)
    tile = fa_mod.tile_hd(hd, dtype)
    tiles = fa_mod.SM90_TILES if dtype == "bfloat16" else fa_mod.F32_TILES
    assert points == {(bq, bkv) for t, bq, bkv in tiles if t == tile
                      and fa_mod.smem_bytes(bq, bkv, hd, ELT[dtype]) <= SXM.smem_per_block}
    for bq, bkv in points:  # the hint's bytes are the tile's
        hint = region.hints[pp_key({"block_q": bq, "block_kv": bkv})]
        assert hint["vmem_bytes"] == fa_mod.smem_bytes(bq, bkv, tile, ELT[dtype])


@pytest.mark.parametrize("hd,dtype,tile", [(80, "bfloat16", 128), (80, "float32", 128),
                                           (256, "bfloat16", 256), (8, "bfloat16", 16),
                                           (4, "float32", 16), (20, "float32", 32),
                                           (136, "bfloat16", 256), (64, "float32", 64)])
def test_a_head_dim_runs_on_the_least_tile_at_or_above_it(hd, dtype, tile):
    assert fa_mod.tile_hd(hd, dtype) == tile
    assert fa_mod.smem_bytes(64, 32, hd, ELT[dtype]) == fa_mod.smem_bytes(64, 32, tile, ELT[dtype])


@pytest.mark.parametrize("hd,dtype", [(20, "bfloat16"), (264, "bfloat16"), (18, "float32"),
                                      (260, "float32"), (4, "bfloat16")])
def test_head_dims_off_the_16_byte_rule_raise_with_the_limit(hd, dtype):
    """Off the kernels' 16-byte rule a head dim runs, padded to the rule;
    past 256 it raises with the limit, in the wrapper and the emit layer."""
    if hd > fa_mod.HD_MAX:
        assert fa_mod.tile_hd(hd, dtype) is None
        assert not fa_mod.launchable(hd, dtype, 64, 32)
        with pytest.raises(ValueError, match=r"up to 256"):
            fa_ops.flash_region(2048, hd, dtype, arch=SXM)
        assert re.search(r"up to 256", fa_mod.head_dim_error(hd, dtype))
        return
    hd_run = fa_mod.padded_hd(hd, dtype)
    assert hd_run % fa_mod.HD_MULTIPLE[dtype] == 0 and hd <= hd_run < hd + 8
    assert fa_mod.head_dim_error(hd, dtype) is None
    assert fa_mod.tile_hd(hd, dtype) == fa_mod.tile_hd(hd_run, dtype)
    assert fa_mod.launchable(hd, dtype, 64, 32)
    assert list(fa_ops.flash_region(2048, hd, dtype, arch=SXM).space.points())


@pytest.mark.parametrize("hd", [12, 36, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_off_rule_head_dims_match_the_jax_kernel(hd, dtype):
    """The plain version against the JAX kernel at head dims off the rule
    (the JAX kernel takes every hd), and the wrapper's padding: the padded
    inputs at the true hd's scale give the same first hd columns."""
    q, k, v = qkv_numpy(seed=300 + hd, S=128, H=2, KV=1, hd=hd)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ref = jax_fa_ops.attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                               block_q=64, block_kv=64)
    tdt = getattr(torch, dtype)
    qkv = carry.attention_inputs(q, k, v, device="cpu", dtype=tdt)
    out = fa_mod.flash_attention(*qkv, block_q=64, block_kv=32)
    assert out.dtype == tdt and tuple(out.shape) == q.shape
    assert_close(out, ref, dtype, f"flash {dtype} hd {hd}")
    hd_run = fa_mod.padded_hd(hd, dtype)
    padded = [fa_mod.pad_head_dim(t, hd_run) for t in qkv]
    assert all(p.is_contiguous() and p.shape[-1] == hd_run for p in padded)
    assert torch.equal(padded[0][..., hd:], torch.zeros_like(padded[0][..., hd:]))
    got = fa_mod.attention_plain(*padded, scale=1.0 / hd ** 0.5)[..., :hd]
    assert_close(got, ref, dtype, f"flash {dtype} hd {hd} padded to {hd_run}")


@pytest.mark.parametrize("hd,dtype", [(12, "bfloat16"), (36, "bfloat16"), (100, "bfloat16"),
                                      (6, "float32"), (50, "float32")])
def test_emit_offers_the_rounded_head_dims_points(hd, dtype):
    """At an hd off the rule the emit layer offers exactly the points (and
    hints) of the hd the wrapper pads it to."""
    region = fa_ops.flash_region(2048, hd, dtype, arch=SXM, heads=32)
    rounded = fa_ops.flash_region(2048, fa_mod.padded_hd(hd, dtype), dtype, arch=SXM,
                                  heads=32)
    points = [pp_key(p) for p in region.space.points()]
    assert points and points == [pp_key(p) for p in rounded.space.points()]
    assert region.hints == rounded.hints
    assert all(fa_mod.launchable(hd, dtype, p["block_q"], p["block_kv"])
               for p in region.space.points())


def test_the_head_dim_rule_and_tiles_are_the_sources():
    """tile_hd in the sources takes the multiples the Python rule takes,
    up to 256, and both tables have their hd-256 tiles."""
    for stem, dtype in (("flash_attention_sm90", "bfloat16"), ("flash_attention", "float32")):
        text = (CSRC / f"{stem}.cu").read_text()
        m = re.search(r"if \(hd < (\d+) \|\| hd > (\d+) \|\| hd % (\d+)\) return 0;", text)
        assert m, stem
        low, high, mult = map(int, m.groups())
        assert (low, high, mult) == (fa_mod.HD_MULTIPLE[dtype], fa_mod.HD_MAX,
                                     fa_mod.HD_MULTIPLE[dtype])
        assert "ht == HD && bq == BQ && bkv == BKV" in text
    assert {(bq, bkv) for t, bq, bkv in fa_mod.SM90_TILES if t == 256} == {
        (64, 32), (64, 64), (128, 32), (128, 64)}
    assert {(bq, bkv) for t, bq, bkv in fa_mod.F32_TILES if t == 256} == {(64, 32)}
