"""The wgmma flash backward's emit layer, models and split arithmetic, on
the CPU (the kernel itself runs on the card: ``chip_smoke.py``).

* The emitted points of ``flash_attention_bwd`` are exactly the
  instantiated tiles (read from the sources' tile lists) times the
  ``kv_split`` values that divide the group; ``kv_split`` 1 alone at tile
  hd 256 and in float32, which run on the ``mma.sync`` kernel.
* ``bwd_smem_bytes`` and ``bwd_scratch_bytes`` equal what the source's
  ``Tile`` and ``scratch_bytes`` compute, their expressions read from the
  source and evaluated for every instantiated tile.
* ``bwd_launchable``, the emit filter and the wrapper's check, refuses a
  ``kv_split`` that does not divide the group and a tile not instantiated.
* A plain model of the split: each partial's dk and dv is
  ``attention_bwd_plain`` over the query heads the kernel's CTA of that
  split walks (``split_heads``, the source's ``h0 = kvh * G + split *
  heads``), and their sum in split order equals the whole backward within
  the float32 ``DEFAULT_TOL`` (the sums differ only in order).
"""
from __future__ import annotations

import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from conformance import DEFAULT_TOL
from repro_torch.core import pp_key
from repro_torch.core.arch import from_properties
from repro_torch.kernels.flash_attention import flash_attention as fa_mod
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_bwd_plain, attention_ref

CSRC = Path(fa_mod.__file__).resolve().parents[2] / "csrc"
SM90_SOURCE = (CSRC / "flash_attention_bwd_sm90.cu").read_text()
MMA_SOURCE = (CSRC / "flash_attention_bwd.cuh").read_text()
# an H100 SXM from faked device properties (no card here)
SXM = from_properties(SimpleNamespace(
    name="NVIDIA H100 80GB HBM3", multi_processor_count=132, L2_cache_size=50 * 2**20,
    shared_memory_per_block=48 * 1024, warp_size=32))


def source_tiles(source: str, macro: str) -> set:
    """The (hd, block_q, block_kv) of a ``#define macro(X) X(..) ..`` list."""
    body = re.search(r"#define " + macro + r"\(X\)(.*?)\n\n", source, re.S).group(1)
    return {tuple(map(int, t)) for t in re.findall(r"X\((\d+), (\d+), (\d+)\)", body)}


def test_bwd_tile_sets_are_the_sources():
    assert source_tiles(SM90_SOURCE, "FLASH_BWD_SM90_TILES") == fa_mod.BWD_SM90_TILES
    assert source_tiles(MMA_SOURCE, "FLASH_BWD_TILES_F32") == fa_mod.BWD_MMA_TILES["float32"]
    assert source_tiles(MMA_SOURCE, "FLASH_BWD_TILES_BF16") == fa_mod.BWD_MMA_TILES["bfloat16"]
    assert fa_mod.BWD_TILES["bfloat16"] == (fa_mod.BWD_SM90_TILES
                                            | fa_mod.BWD_MMA_TILES["bfloat16"])
    assert all(t <= 128 for t, _, _ in fa_mod.BWD_SM90_TILES)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("hd", [16, 36, 64, 128, 200, 256])
def test_bwd_emitted_points_are_the_tiles_times_the_splits(hd, group, dtype):
    region = fa_ops.flash_bwd_region(4096, hd, dtype, arch=SXM, heads=32, group=group)
    got = {(p["block_q"], p["block_kv"], p.get("kv_split", 1)) for p in region.space.points()}
    tile = fa_mod.tile_hd(fa_mod.padded_hd(hd, dtype), dtype)
    sm90 = dtype == "bfloat16" and tile <= 128
    splits = [s for s in (1, 2, 4, 8) if group % s == 0] if sm90 else [1]
    want = {(bq, bkv, s) for t, bq, bkv in fa_mod.BWD_TILES[dtype] if t == tile
            for s in splits}
    assert got == want
    assert all("kv_split" in p for p in region.space.points()) == (sm90 and group > 1)


def _c_expr(expr: str, env: dict) -> int:
    """A C++ integer expression of the sources (products, sums, one
    ternary ``a ? b : c``, ``2ll`` literals) evaluated in Python."""
    expr = re.sub(r"(\d+)ll\b", r"\1", " ".join(expr.split()))
    cond = re.fullmatch(r"(.+?)\s*\?\s*(.+?)\s*:\s*(.+)", expr)
    if cond:
        return _c_expr(cond.group(2) if _c_expr(cond.group(1), env) else cond.group(3), env)
    return int(eval(expr, {}, dict(env)))  # noqa: S307 - the repository's own source


def tile_constants(hd: int, bq: int, bkv: int) -> dict:
    """``Tile<hd, bq, bkv>``'s constants, from the source's expressions."""
    env = {name: int(v) for name, v in re.findall(
        r"^constexpr int (k\w+) = (\d+);", SM90_SOURCE, re.M)}
    env.update(HD=hd, BQ=bq, BKV=bkv)
    body = re.search(r"struct Tile \{(.*?)\n\};", SM90_SOURCE, re.S).group(1)
    for name, expr in re.findall(r"static constexpr (?:int|long long) (\w+) =\s*(.*?);",
                                 body, re.S):
        env[name] = _c_expr(expr, env)
    return env


@pytest.mark.parametrize("tile", sorted(fa_mod.BWD_SM90_TILES))
def test_bwd_smem_model_is_the_sources_tile(tile):
    hd, bq, bkv = tile
    want = tile_constants(hd, bq, bkv)
    assert want["kSmem"] == max(want["kDqSmem"], want["kDkvSmem"])
    for run_hd in {hd, max(8, hd // 2 + 8)}:  # a full tile and one padded inside it
        assert fa_mod.bwd_smem_bytes(bq, bkv, run_hd, 2) == want["kSmem"]
    assert want["kSmem"] <= SXM.smem_per_block


@pytest.mark.parametrize("shape", [(1, 4096, 4, 64, 1), (1, 4096, 4, 64, 8), (4, 2047, 8, 40, 2),
                                   (2, 7, 1, 128, 4)])
def test_bwd_scratch_model_is_the_sources(shape):
    B, S, KV, hd, kv_split = shape
    body = re.search(r"long long scratch_bytes\(int B, int S, int KV, int hd, int kv_split\) "
                     r"\{\s*return (.*?);", SM90_SOURCE, re.S).group(1)
    want = _c_expr(body, dict(B=B, S=S, KV=KV, hd=hd, kv_split=kv_split))
    assert fa_mod.bwd_scratch_bytes(B, S, KV, hd, kv_split) == want
    # two float32 partials of (kv_split, B, S, KV, hd) above 1: 268 MB at the
    # training step's B=4, S=4096 and kv_split 8
    assert want == (0 if kv_split == 1 else 2 * 4 * kv_split * B * S * KV * hd)
    assert fa_mod.bwd_scratch_bytes(4, 4096, 4, 64, 8) == 268_435_456


@pytest.mark.parametrize("hd,dtype,tile,kv_split,group", [
    (64, "bfloat16", (128, 128), 1, 8),    # (64,128,128) instantiated; (64,64,...) below
    (64, "bfloat16", (64, 64), 3, 6),      # not a power of two
    (64, "bfloat16", (64, 64), 4, 2),      # larger than the group
    (64, "bfloat16", (64, 64), 2, 7),      # does not divide 7
    (64, "bfloat16", (64, 64), 0, 8),
    (64, "bfloat16", (32, 32), 1, 8),      # an mma.sync tile, not the wgmma kernel's
    (128, "bfloat16", (128, 64), 1, 2),    # block_q 128 at tile hd 128: not instantiated
    (256, "bfloat16", (64, 32), 2, 2),     # hd 256 runs on mma.sync: no split
    (64, "float32", (64, 64), 2, 8),       # float32 runs on mma.sync: no split
    (64, "float32", (128, 128), 1, 8),     # not an mma.sync tile
    (300, "bfloat16", (64, 64), 1, 1),     # past the largest head dim
])
def test_bwd_launchable_refuses_what_the_kernel_does_not_take(hd, dtype, tile, kv_split, group):
    ok = fa_mod.bwd_launchable(hd, dtype, *tile, kv_split=kv_split, group=group)
    assert ok == (tile == (128, 128) and hd == 64 and dtype == "bfloat16")


def test_bwd_launchable_takes_every_power_of_two_split_of_the_group():
    for group in (1, 2, 4, 8, 6, 16):
        for s in (1, 2, 4, 8, 16):
            want = group % s == 0
            assert fa_mod.bwd_launchable(64, "bfloat16", 64, 64, s, group) == want
            assert fa_mod.bwd_launchable(64, "float32", 64, 64, s, group) == (s == 1)


def split_heads(group: int, kv_split: int, part: int) -> range:
    """The query heads of a GQA group (0 .. group - 1) that partial ``part``
    of a ``kv_split`` backward sums, as the dk/dv pass assigns them:
    consecutive, ``group // kv_split`` of them, in order."""
    n = group // kv_split
    return range(part * n, (part + 1) * n)


def test_split_heads_is_the_sources_assignment():
    # the dk/dv CTA of split `split` walks heads h0 .. h0 + heads - 1
    assert re.search(r"const int heads = G / kv_split;.*\n.*const int h0 = kvh \* G \+ "
                     r"split \* heads;", SM90_SOURCE)
    assert [list(split_heads(8, 4, p)) for p in range(4)] == [[0, 1], [2, 3], [4, 5], [6, 7]]


def _split_model(q, k, v, o, lse, do, kv_split):
    """dk and dv as the kernel's split forms them: partial ``part`` is the
    backward over the query heads :func:`split_heads` gives it (every KV head's
    group cut alike), the partials summed in ``part`` order; dq of each
    query head from its own partial."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    dq = torch.zeros_like(q)
    dk = dv = None
    for part in range(kv_split):
        heads = list(split_heads(G, kv_split, part))
        index = torch.tensor([kvh * G + g for kvh in range(KV) for g in heads])
        sub = [t.index_select(2, index).contiguous() for t in (q, o, do)]
        p_dq, p_dk, p_dv = attention_bwd_plain(sub[0], k, v, sub[1],
                                               lse.index_select(1, index).contiguous(), sub[2])
        dq[:, :, index] = p_dq
        dk = p_dk if dk is None else dk + p_dk
        dv = p_dv if dv is None else dv + p_dv
    return dq, dk, dv


@pytest.mark.parametrize("group,kv_split", [(2, 2), (4, 2), (4, 4), (8, 2), (8, 8)])
def test_split_model_sums_to_the_plain_backward(group, kv_split):
    rng = np.random.default_rng(group * 10 + kv_split)
    B, S, KV, hd = 2, 40, 2, 16
    H = KV * group
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd), (B, S, H, hd)))
    o, lse = attention_ref(q, k, v, return_lse=True)
    want = attention_bwd_plain(q, k, v, o, lse, do)
    got = _split_model(q, k, v, o, lse, do, kv_split)
    rtol, atol = DEFAULT_TOL["float32"]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(g, w, rtol=rtol, atol=atol, msg=name)
    # the partials cover the group once, in order
    heads = [h for p in range(kv_split) for h in split_heads(group, kv_split, p)]
    assert heads == list(range(group))


def test_bwd_hint_latency_falls_with_the_split_at_one_batch_row():
    """At B=1 the dk/dv pass's first key block walks every head of its
    group over all q blocks; the hint's latency term, which ranks the
    split, shortens as kv_split spreads the group."""
    region = fa_ops.flash_bwd_region(4096, 64, "bfloat16", arch=SXM, heads=32, group=8)
    lat = {}
    for p in region.space.points():
        if (p["block_q"], p["block_kv"]) == (64, 64):
            lat[p["kv_split"]] = region.hints[pp_key(p)]["latency_s"]
    assert sorted(lat) == [1, 2, 4, 8]
    assert lat[1] > lat[2] > lat[4] >= lat[8] > 0
