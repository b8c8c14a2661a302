"""The port's emit layer: what the scans and stress need of it.

A dim's ``max_tile`` caps its ladder (a CTA has at most 1024 threads), a
``pow2_only`` dim ladders over powers of two alone (compile-time tiles), a
policy's ``grid_multiplier`` counts the batch into the hint's CTAs and its
``flop_rate`` sets the rate its flops are charged at, and a space pruned
by shared memory reports the points it enumerates.  Dims without
``max_tile`` or ``pow2_only`` keep the signatures they had.
"""
from __future__ import annotations

import pytest

from repro_torch.core import ParamSpace, PerfParam, pp_key
from repro_torch.core.arch import CPU_HOST
from repro_torch.core.emit import TileDim, TilePolicy, pow2_ladder, space_signature
from repro_torch.kernels.exb import ops as exb_ops


@pytest.mark.parametrize(
    "dim,ladder",
    [
        (TileDim("d", 8192, semantic="grid", min_tile=2, max_tile=64), (2, 4, 8, 16, 32, 64)),
        (TileDim("d", 2560, semantic="grid", min_tile=32, max_tile=1024),
         (32, 64, 128, 256, 512)),
        (TileDim("d", 128, semantic="grid", min_tile=32, max_tile=1024), (32, 64, 128)),
        (TileDim("d", 8192, semantic="grid", min_tile=2), (64, 128, 256, 512, 1024, 2048,
                                                          4096, 8192)),
    ],
)
def test_max_tile_caps_the_ladder(dim, ladder):
    assert pow2_ladder(dim, CPU_HOST) == ladder


@pytest.mark.parametrize(
    "extent,ladder",
    [(2048, (32, 64, 128, 256)), (2000, (32, 64, 128, 256)), (200, (32, 64, 128, 256)),
     (100, (32, 64, 128)), (50, (32, 64)), (20, (32,))],
)
def test_pow2_only_ladders_powers_of_two_past_the_extent(extent, ladder):
    dim = TileDim("d", extent, semantic="sequential", min_tile=32, max_tile=256,
                  allow_padding=True, pow2_only=True)
    assert pow2_ladder(dim, CPU_HOST) == ladder
    # without padding only the dividing powers of two survive
    strict = TileDim("d", extent, semantic="sequential", min_tile=32, max_tile=256,
                     pow2_only=True)
    assert pow2_ladder(strict, CPU_HOST) == tuple(v for v in ladder if extent % v == 0)


def test_pow2_only_enters_the_signature_only_when_set():
    plain = (TileDim("d", 64, semantic="grid", max_tile=64),)
    pow2 = (TileDim("d", 64, semantic="grid", max_tile=64, pow2_only=True),)
    kw = dict(policy="p", version=1, kernel="k", arch=CPU_HOST, budget=0, point_keys=["x"])
    assert space_signature(dims=plain, **kw) != space_signature(dims=pow2, **kw)


def test_flop_rate_sets_the_rate_the_hint_charges():
    slow = _policy(traffic_model=lambda bp, p: (1e12, 0.0)).emit(CPU_HOST, {"n": 4})
    fast = _policy(traffic_model=lambda bp, p: (1e12, 0.0),
                   flop_rate=lambda arch, bp: arch.peak_flops).emit(CPU_HOST, {"n": 4})
    for key, hint in slow.hints.items():
        overhead = hint["waves"] * CPU_HOST.wave_overhead_s
        ratio = (hint["est_s"] - overhead) / (fast.hints[key]["est_s"] - overhead)
        assert ratio == pytest.approx(CPU_HOST.peak_flops / CPU_HOST.peak_flops_fp32)


def test_latency_model_is_a_floor_under_the_roofline():
    """The hint takes the largest of flop time, byte time and the kernel's
    latency; a latency under the roofline changes nothing."""
    base = _policy().emit(CPU_HOST, {"n": 4})
    low = _policy(latency_model=lambda arch, bp, p: 1e-9).emit(CPU_HOST, {"n": 4})
    high = _policy(latency_model=lambda arch, bp, p: 1.0 * p["a"]).emit(CPU_HOST, {"n": 4})
    for key, hint in base.hints.items():
        assert low.hints[key]["est_s"] == hint["est_s"] and hint["latency_s"] == 0.0
        overhead = hint["waves"] * CPU_HOST.wave_overhead_s
        assert high.hints[key]["est_s"] == pytest.approx(overhead + high.hints[key]["latency_s"])
    assert [p["a"] for p in high.space.points()][0] == 1  # the shortest chain ranks first


def test_max_tile_must_be_positive():
    with pytest.raises(ValueError, match="max_tile"):
        TileDim("d", 64, max_tile=0)


def _policy(vmem_model=lambda bp, p: 0, traffic_model=lambda bp, p: (0.0, 1e9), **kw):
    return TilePolicy(
        kernel="toy",
        dims=lambda bp: (TileDim("a", bp["n"], semantic="grid"),
                         TileDim("b", bp["n"], semantic="grid")),
        vmem_model=vmem_model,
        traffic_model=traffic_model,
        **kw,
    )


def test_shared_memory_prunes_points_and_size_counts_what_is_left():
    free = _policy().emit(CPU_HOST, {"n": 16})
    budget = CPU_HOST.vmem_budget()
    kept = _policy(
        vmem_model=lambda bp, p: budget * p["a"] * p["b"] // 4
    ).emit(CPU_HOST, {"n": 16})
    points = list(kept.space.points())
    assert all(p["a"] * p["b"] <= 4 for p in points)
    assert kept.space.size() == len(points) == 6
    assert free.space.size() == 25
    assert kept.signature != free.signature


def test_grid_multiplier_counts_the_batch_into_the_hint():
    one = _policy().emit(CPU_HOST, {"n": 16})
    eight = _policy(grid_multiplier=lambda bp: 8).emit(CPU_HOST, {"n": 16})
    for key, hint in one.hints.items():
        assert eight.hints[key]["programs"] == 8 * hint["programs"]
        assert eight.hints[key]["sm_fill"] >= hint["sm_fill"]


def test_subset_size_is_its_member_count():
    space = ParamSpace([PerfParam("a", (1, 2, 4)), PerfParam("b", (1, 2))])
    sub = space.subset([{"a": 1, "b": 2}, {"a": 4, "b": 1}])
    assert space.size() == 6 and sub.size() == 2
    assert [pp_key(p) for p in sub.points()] == [pp_key({"a": 1, "b": 2}),
                                                 pp_key({"a": 4, "b": 1})]


def test_dims_without_max_tile_keep_their_signature():
    """max_tile enters the signature only when set, so the spaces of dims
    without it (and the DB entries keyed on them) keep their signatures.
    The exb space's is pinned: it holds split (a capped "pieces" dim)."""
    dims = (TileDim("block_iv", 16, semantic="grid"), TileDim("block_iz", 16, semantic="grid"))
    capped = (TileDim("block_iv", 16, semantic="grid", max_tile=16),) + dims[1:]
    kw = dict(policy="p", version=1, kernel="k", arch=CPU_HOST, budget=0, point_keys=["x"])
    assert space_signature(dims=dims, **kw) != space_signature(dims=capped, **kw)
    region = exb_ops.exb_region(dims=(16, 16, 128, 65), arch=CPU_HOST)
    assert region.space_signature == "ddbe02900fa1301d"
