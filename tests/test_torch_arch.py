"""The port's H100 ArchSpec and the spaces emitted from it.

Device properties are faked (no card here): an SXM name, a PCIe name and an
unknown card.  The emitted exb and flash spaces must be deterministic,
every point must fit the opt-in shared memory per block, and the exb hint
must rank the single-CTA point last while keeping many-CTA points in the
staged prescreen's survivors.
"""
from __future__ import annotations

from types import SimpleNamespace

import pytest

from repro_torch.core import arch as arch_mod
from repro_torch.core import default_prescreen_k, pp_key
from repro_torch.core.arch import ArchSpec, from_properties
from repro_torch.kernels.exb import ops as exb_ops
from repro_torch.kernels.flash_attention import flash_attention as fa_mod
from repro_torch.kernels.flash_attention import ops as fa_ops


def props(name, sms=132, l2=50 * 2**20):
    return SimpleNamespace(
        name=name, multi_processor_count=sms, L2_cache_size=l2,
        shared_memory_per_block=48 * 1024, warp_size=32,
    )


SXM = from_properties(props("NVIDIA H100 80GB HBM3"))
PCIE = from_properties(props("NVIDIA H100 PCIe", sms=114))


def test_h100_parts_from_the_datasheet():
    assert (SXM.backend, SXM.sm_count, SXM.smem_per_block) == ("cuda", 132, 232_448)
    assert SXM.hbm_bandwidth == 3.35e12 and SXM.peak_flops == 989e12
    assert (PCIE.sm_count, PCIE.hbm_bandwidth, PCIE.peak_flops) == (114, 2.0e12, 756e12)
    unknown = from_properties(props("Some Other GPU", sms=40))
    assert unknown.smem_per_block == 48 * 1024 and unknown.sm_count == 40
    assert SXM.vmem_budget() == SXM.smem_per_block


def test_arch_round_trips_through_bp_entries():
    entries = SXM.bp_entries()
    assert all(k.startswith("arch_") for k in entries)
    assert ArchSpec.from_bp_entries(entries) == SXM
    with pytest.raises(KeyError):
        ArchSpec.from_bp_entries({})


def test_cpu_device_detects_the_cpu_host():
    assert arch_mod.detect("cpu") is arch_mod.CPU_HOST
    assert arch_mod.CPU_HOST.backend == "cpu"


SPACES = {
    "exb": lambda a: exb_ops.exb_region(arch=a),
    "flash_bf16": lambda a: fa_ops.flash_region(2048, 64, "bfloat16", arch=a),
    "flash_f32": lambda a: fa_ops.flash_region(2048, 64, "float32", arch=a),
    "flash_padded": lambda a: fa_ops.flash_region(2000, 64, "bfloat16", arch=a),
    "flash_padded_f32": lambda a: fa_ops.flash_region(2000, 64, "float32", arch=a),
}


@pytest.mark.parametrize("arch", [SXM, PCIE], ids=["sxm", "pcie"])
@pytest.mark.parametrize("space", sorted(SPACES))
def test_emitted_spaces_are_deterministic_and_fit(space, arch):
    first, second = SPACES[space](arch), SPACES[space](arch)
    assert first.space_signature == second.space_signature
    points = [pp_key(p) for p in first.space.points()]
    assert points == [pp_key(p) for p in second.space.points()]
    assert len(points) >= 2
    for key in points:
        assert first.hints[key]["vmem_bytes"] <= arch.smem_per_block


def test_signature_names_the_arch():
    assert SPACES["exb"](SXM).space_signature != SPACES["exb"](PCIE).space_signature


def test_flash_space_is_what_the_kernel_takes():
    """float32: the 3xTF32 kernel's instantiated tiles, block_q from four
    warps of 16 rows, block_kv adding no CTAs, also past a sequence they do
    not divide.  bf16: the wgmma kernel's instantiated tiles, block_q from
    a warpgroup's 64 rows, also past a sequence they do not divide."""
    region = SPACES["flash_padded_f32"](SXM)
    pts = list(region.space.points())
    assert {p["block_q"] for p in pts} == {64, 128}
    assert {p["block_kv"] for p in pts} == {32, 64, 128}
    for p in pts:
        h = region.hints[pp_key(p)]
        assert h["programs"] == -(-2000 // p["block_q"])
        assert h["vmem_bytes"] == fa_ops.smem_bytes(p["block_q"], p["block_kv"], 64, 4)
        assert (64, p["block_q"], p["block_kv"]) in fa_mod.F32_TILES
    # the full extents are too large for one CTA's shared memory
    assert all(p["block_q"] < 2000 and p["block_kv"] < 2000 for p in pts)

    region = SPACES["flash_padded"](SXM)
    pts = list(region.space.points())
    assert {p["block_q"] for p in pts} == {64, 128}
    assert {p["block_kv"] for p in pts} == {32, 64, 128, 256}
    for p in pts:
        h = region.hints[pp_key(p)]
        assert h["programs"] == -(-2000 // p["block_q"])
        assert h["vmem_bytes"] == fa_ops.smem_bytes(p["block_q"], p["block_kv"], 64, 2)
        assert (64, p["block_q"], p["block_kv"]) in fa_mod.SM90_TILES


@pytest.mark.parametrize("arch", [SXM, PCIE], ids=["sxm", "pcie"])
def test_exb_hint_ranks_for_the_sms(arch):
    """Every (block_iv, block_iz) of the paper's grain, with split from 1
    to 32 (a piece keeps 64 of the plane's 2080 float4s) while the call
    launches at most 8 CTAs an SM."""
    region = SPACES["exb"](arch)
    ranked = list(region.space.points())
    tiles = (1, 2, 4, 8, 16)
    assert sorted(pp_key(p) for p in ranked) == sorted(
        pp_key({"block_iv": biv, "block_iz": biz, "split": s})
        for biv in tiles for biz in tiles for s in (1, 2, 4, 8, 16, 32)
        if s == 1 or (16 // biv) * (16 // biz) * s <= 8 * arch.sm_count)
    assert len(ranked) == {132: 140, 114: 130}[arch.sm_count]
    assert ranked[-1] == {"block_iv": 16, "block_iz": 16, "split": 1}
    top = ranked[: default_prescreen_k(len(ranked))]
    programs = [region.hints[pp_key(p)]["programs"] for p in top]
    assert max(programs) >= 64
