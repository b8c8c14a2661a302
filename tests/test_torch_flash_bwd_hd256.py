"""The flash backward at tile head dim 256 and the float32 kernel's tiles,
on the CPU (the kernels themselves run on the card: ``chip_smoke.py``).

* bf16 at hd 256 runs on the wgmma kernel (``flash_attention_bwd_sm90.cu``):
  its one hd-256 ``Tile``, read from the source's expressions, is what
  ``bwd_smem_bytes`` models and fits the card's opt-in shared memory, and
  its dk/dv pass has two warpgroups sharing the 64 keys.
* ``kv_split`` takes every divisor of the GQA group, in both kernels: the
  emitted points at hd 256 with recurrentgemma-2b's group of 10 are the
  instantiated tiles times {1, 2, 5, 10}, and ``bwd_launchable`` refuses a
  non-divisor; the float32 hint's latency term falls as the split grows.
* The split model (each partial the plain backward over the query heads
  its CTA walks, summed in split order) equals the whole backward at
  (group, kv_split) = (10, 5) and (10, 10), within the float32
  ``DEFAULT_TOL``.
* ``attention_bwd_plain`` at hd 256, 10|1 heads, matches the JAX
  ``_flash_bwd`` (``jax.vjp`` of ``flash_attention_xla``, op by op in bf16
  as ``test_torch_train_flash_bwd`` runs it): ``DEFAULT_TOL`` per element,
  and in bf16 the worst row within 4·2⁻⁸.
* The float32 ``mma.sync`` kernel (``flash_attention_bwd.cuh``): every
  tile's ``DqTile``/``DkvTile`` shared memory, from the source's
  expressions, equals ``bwd_smem_bytes``, and its warp layout (16-row
  slabs times groups) gives each warp whole n-tiles of 8.
"""
from __future__ import annotations

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformance import DEFAULT_TOL
from repro.models.attention import _flash_forward_blocks, flash_attention_xla
from repro_torch.core import pp_key
from repro_torch.kernels.flash_attention import flash_attention as fa_mod
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_bwd_plain, attention_ref
from test_torch_flash_bwd_sm90 import (
    MMA_SOURCE, SM90_SOURCE, SXM, _c_expr, _split_model, source_tiles, split_heads,
    tile_constants,
)

BF16_ROW = 4 * 2.0 ** -8
GROUP = 10  # recurrentgemma-2b: 10 query heads, 1 KV head


def test_hd256_tile_is_the_smem_model_and_fits():
    assert (256, 64, 64) in source_tiles(SM90_SOURCE, "FLASH_BWD_SM90_TILES")
    c = tile_constants(256, 64, 64)
    assert (c["kBoxes"], c["kColGroups"], c["kDkvThreads"], c["kDqThreads"]) == (4, 2, 256, 128)
    # K, V once, two Q/dO stages with their stats, P^T and dS^T as bf16
    assert c["kStagedBytes"] == 2 * 2 * 64 * 64
    assert c["kDkvSmem"] == 1024 + 2 * 32768 + 2 * (2 * 32768 + 512) + 16384 + 64 == 215104
    assert c["kDqSmem"] == 1024 + 2 * 32768 + 2 * 2 * 32768 + 64 == 197696
    for hd in (256, 200, 136):  # every hd that runs on tile hd 256
        assert fa_mod.bwd_smem_bytes(64, 64, hd, 2) == c["kSmem"]
    assert c["kSmem"] <= SXM.smem_per_block
    # below hd 256 one warpgroup a 64-key slab and nothing staged
    low = tile_constants(128, 64, 64)
    assert (low["kColGroups"], low["kStagedBytes"], low["kDkvThreads"]) == (1, 0, 128)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("hd", [256, 200, 136])
def test_hd256_points_are_the_tiles_times_the_divisors_of_10(hd, dtype):
    region = fa_ops.flash_bwd_region(2048, hd, dtype, arch=SXM, heads=16, group=GROUP)
    got = {(p["block_q"], p["block_kv"], p["kv_split"]) for p in region.space.points()}
    tiles = {(bq, bkv) for t, bq, bkv in fa_mod.BWD_TILES[dtype] if t == 256}
    assert got == {(bq, bkv, s) for bq, bkv in tiles for s in (1, 2, 5, 10)}
    elt = 2 if dtype == "bfloat16" else 4
    assert all(fa_mod.bwd_smem_bytes(p["block_q"], p["block_kv"], hd, elt)
               <= SXM.smem_per_block for p in region.space.points())


@pytest.mark.parametrize("group", [1, 6, 7, 10, 12, 32])
def test_bwd_launchable_takes_the_divisors_and_refuses_the_rest(group):
    for s in range(0, group + 3):
        want = s >= 1 and group % s == 0
        assert fa_mod.bwd_launchable(256, "bfloat16", 64, 64, s, group) == want, s
        assert fa_mod.bwd_launchable(64, "bfloat16", 128, 64, s, group) == want, s
        assert fa_mod.bwd_launchable(256, "float32", 64, 32, s, group) == want, s
    # the sources' checks are the same rule: the group modulo the split
    for source in (SM90_SOURCE, MMA_SOURCE):
        assert re.search(r"\(H / KV\) % kv_split", source)
        assert "kv_split & (kv_split - 1)" not in source


def test_f32_hint_latency_falls_with_the_split_at_hd256():
    """recurrentgemma-2b at B=1: the float32 dk/dv pass's first key block
    walks all 10 heads; the hint's latency term, which ranks the split,
    shortens as kv_split spreads them."""
    region = fa_ops.flash_bwd_region(2048, 256, "float32", arch=SXM, heads=16, group=GROUP)
    lat = {p["kv_split"]: region.hints[pp_key(p)]["latency_s"] for p in region.space.points()
           if (p["block_q"], p["block_kv"]) == (64, 32)}
    assert sorted(lat) == [1, 2, 5, 10]
    assert lat[1] > lat[2] > lat[5] > lat[10] > 0


@pytest.mark.parametrize("kv_split", [5, 10])
def test_split_model_sums_to_the_plain_backward_at_group_10(kv_split):
    rng = np.random.default_rng(100 + kv_split)
    B, S, KV, hd = 1, 24, 1, 256
    H = KV * GROUP
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd), (B, S, H, hd)))
    o, lse = attention_ref(q, k, v, return_lse=True)
    want = attention_bwd_plain(q, k, v, o, lse, do)
    got = _split_model(q, k, v, o, lse, do, kv_split)
    rtol, atol = DEFAULT_TOL["float32"]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(g, w, rtol=rtol, atol=atol, msg=name)
    heads = [h for p in range(kv_split) for h in split_heads(GROUP, kv_split, p)]
    assert heads == list(range(GROUP))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_plain_matches_jax_flash_bwd_at_hd256(dtype):
    S, H, KV, hd, block = 48, GROUP, 1, 256, 16
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    rng = np.random.default_rng(256)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((1, S, H, hd), (1, S, KV, hd), (1, S, KV, hd), (1, S, H, hd))]
    q, k, v, do = (jnp.asarray(a, jdt) for a in arrays)
    with jax.disable_jit():  # bf16 op by op; float32 the same way, for one code path
        o, lse = _flash_forward_blocks(q, k, v, block, block)
        _, vjp = jax.vjp(lambda a, b, c: flash_attention_xla(a, b, c, block, block), q, k, v)
        want = vjp(do)
    t = [torch.from_numpy(np.asarray(a, np.float32)).to(tdt) for a in (q, k, v, o, do)]
    tlse = torch.from_numpy(np.asarray(lse, np.float32)).reshape(1, H, S)
    got = attention_bwd_plain(t[0], t[1], t[2], t[3], tlse, t[4])
    rtol, atol = DEFAULT_TOL[dtype]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == tdt
        port, ref = g.float().numpy(), np.asarray(w, np.float32)
        np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol, err_msg=f"{name} {dtype}")
        if dtype == "bfloat16":
            rows = np.linalg.norm(port - ref, axis=-1) / np.maximum(
                np.linalg.norm(ref, axis=-1), 1e-30)
            assert rows.max() <= BF16_ROW, f"{name}: worst row {rows.max()}"


def f32_tile_constants(hd: int, bq: int, bkv: int) -> dict:
    """``DqTile<hd, bq, bkv>`` and ``DkvTile``'s constants, from the
    ``.cuh``'s expressions (``min3`` and ``kSmemMax`` as the source defines
    them); keys prefixed ``dq.`` and ``dkv.``."""
    smem_max = int(re.search(r"constexpr long long kSmemMax = (\d+);", MMA_SOURCE).group(1))
    out = {}
    for name, prefix in (("DqTile", "dq."), ("DkvTile", "dkv.")):
        body = re.search(r"struct " + name + r" \{(.*?)\n\};", MMA_SOURCE, re.S).group(1)
        env = dict(HD=hd, BQ=bq, BKV=bkv, kSmemMax=smem_max)
        for var, expr in re.findall(r"static constexpr (?:int|long long) (\w+) =\s*(.*?);",
                                    body, re.S):
            m = re.fullmatch(r"min3\((.*)\)", expr.strip())
            if m:
                env[var] = min(_c_expr(a, env) for a in m.group(1).split(","))
            else:
                env[var] = _c_expr(expr, env)
            out[prefix + var] = env[var]
    return out


@pytest.mark.parametrize("tile", sorted(fa_mod.BWD_F32_TILES))
def test_f32_smem_model_is_the_sources_tiles(tile):
    assert source_tiles(MMA_SOURCE, "FLASH_BWD_TILES_F32") == fa_mod.BWD_F32_TILES
    hd, bq, bkv = tile
    c = f32_tile_constants(hd, bq, bkv)
    want = max(c["dq.kSmem"], c["dkv.kSmem"])
    for run_hd in {hd, max(4, hd // 2 + 4)}:  # a full tile and one padded inside it
        assert fa_mod.bwd_smem_bytes(bq, bkv, run_hd, 4) == want
    assert want <= fa_mod.BWD_SMEM_MAX == SXM.smem_per_block
    # every warp scores whole n-tiles of the other block and owns whole
    # n-tiles of hd's columns; at most 8 warps, and a warp's 16-row slab
    for p, rows, other in (("dq.", bq, bkv), ("dkv.", bkv, bq)):
        groups = c[p + "kGroups"]
        assert c[p + "kSlabs"] * 16 == rows
        assert c[p + "kThreads"] == 32 * c[p + "kSlabs"] * groups <= 256
        assert other % (8 * groups) == 0 and hd % (8 * groups) == 0
        assert c[p + "kStages"] in (1, 2)
    # the second ring stage is dropped only where it would not fit
    for p in ("dq.", "dkv."):
        two = c[p + "kFixed"] + 2 * c[p + "kStage"]
        assert (c[p + "kStages"] == 2) == (two <= fa_mod.BWD_SMEM_MAX)
