"""The port's emit layer: what the scans and stress need of it.

A dim's ``max_tile`` caps its ladder (a CTA has at most 1024 threads), a
policy's ``grid_multiplier`` counts the batch into the hint's CTAs, and a
space pruned by shared memory reports the points it enumerates.  Dims
without ``max_tile`` keep the signatures they had.
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


def test_max_tile_must_be_positive():
    with pytest.raises(ValueError, match="max_tile"):
        TileDim("d", 64, max_tile=0)


def _policy(vmem_model=lambda bp, p: 0, **kw):
    return TilePolicy(
        kernel="toy",
        dims=lambda bp: (TileDim("a", bp["n"], semantic="grid"),
                         TileDim("b", bp["n"], semantic="grid")),
        vmem_model=vmem_model,
        traffic_model=lambda bp, p: (0.0, 1e9),
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
    """max_tile enters the signature only when set, so the exb and flash
    spaces (and the DB entries keyed on them) are what they were."""
    dims = (TileDim("block_iv", 16, semantic="grid"), TileDim("block_iz", 16, semantic="grid"))
    capped = (TileDim("block_iv", 16, semantic="grid", max_tile=16),) + dims[1:]
    kw = dict(policy="p", version=1, kernel="k", arch=CPU_HOST, budget=0, point_keys=["x"])
    assert space_signature(dims=dims, **kw) != space_signature(dims=capped, **kw)
    region = exb_ops.exb_region(dims=(16, 16, 128, 65), arch=CPU_HOST)
    assert region.space_signature == "4d1b550afd7c403d"
