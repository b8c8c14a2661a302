"""``ssm_scan`` at every state size the JAX kernel takes, up to 256, as far
as the CPU can see it.

The CUDA kernel runs N as NP, N rounded up to a power of two: the states
past N read A = 0 and B = C = 0 in shared memory, so they stay 0 and add
nothing, and past N = 32 a channel's NP / states lanes are more than a
group's 32 / states steps, so its y sums end in a butterfly after the
reduce-scatter.  It runs only on the card, where ``chip_smoke.py`` holds
every emitted point at N = 12 and 64 (and 256 on a narrow width) against
the plain version.  Here: the port's plain version against the JAX kernel
(Pallas in interpret mode) at N = 12 and 64 in float32 and bf16, with the
tolerances of ``tests/test_torch_scans.py`` and
``tests/test_torch_scans_hopper.py``; every emitted point is one the
wrapper takes; the size limit and its message; the shared-memory model at
NP; and a mirror of the kernel's lane reduction, which must leave every
step's sum over all of a channel's lanes stored by exactly one lane.
"""
from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan import ops as jax_ssm_ops
from repro_torch import carry
from repro_torch.core.arch import CPU_HOST, from_properties
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.kernels.ssm_scan import ssm_scan as ssm_mod
from test_torch_arch import props
from test_torch_scans import TOL as SCAN_TOL, ssm_numpy
from test_torch_scans_hopper import BF16_TOL, _bf16, _close

SXM = from_properties(props("NVIDIA H100 80GB HBM3"))
SOURCE = Path(ssm_mod.__file__).resolve().parents[2] / "csrc" / "ssm_scan.cu"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", [12, 64])
def test_plain_ssm_scan_matches_jax_kernel_at_state_size(N, dtype):
    arrays = ssm_numpy(seed=90 + N, B=1, S=32, D=32, N=N)
    if dtype == "bfloat16":
        arrays = _bf16(arrays, f32_slots=(2, 5))  # A and D stay float32
    ref = jax_ssm_ops.scan(*(jnp.asarray(a) for a in arrays), block_d=32, chunk=16)
    args = carry.ssm_inputs(*arrays, device="cpu")
    # 16 states a thread: one lane a channel at N = 12 (NP 16), four at 64
    out = ssm_mod.ssm_scan(*args, block_d=32, chunk=16, states=16)
    assert out.dtype == getattr(torch, dtype) and tuple(out.shape) == arrays[0].shape
    _close(out, ref, SCAN_TOL if dtype == "float32" else BF16_TOL, f"ssm_scan N={N} {dtype}")


@pytest.mark.parametrize("N", [1, 3, 12, 64, 100, 256])
def test_every_emitted_point_is_taken(N):
    """At a narrow shape, every point of the emitted space passes the
    wrapper's check (the CPU route checks as the CUDA route does), has at
    most a warp's lanes a channel, and stages rows of NP values."""
    args = carry.ssm_inputs(*ssm_numpy(seed=95, B=1, S=8, D=64, N=N), device="cpu")
    NP = ssm_mod.pad_states(N)
    for dtype in ("float32", "bfloat16"):
        region = ssm_ops.ssm_region(64, 8, N, 1, arch=CPU_HOST, dtype=dtype)
        points = list(region.space.points())
        assert points
        for p in points:
            ssm_mod._check(*args, p["block_d"], p["chunk"], p["states"])
            assert NP // p["states"] <= 32
            assert ssm_mod.smem_bytes(p["block_d"], p["chunk"], N) == ssm_mod.smem_bytes(
                p["block_d"], p["chunk"], NP)


def test_slice_width_spaces_fit_the_card():
    """At falcon-mamba-7b width every emitted point at N = 12, 64, 256 fits
    the H100's shared memory; N = 256 leaves 8 or 16 states a thread."""
    for N in (12, 64, 256):
        for dtype, elt in (("float32", 4), ("bfloat16", 2)):
            region = ssm_ops.ssm_region(8192, 2048, N, 1, arch=SXM, dtype=dtype)
            points = list(region.space.points())
            assert points
            for p in points:
                assert ssm_mod.smem_bytes(p["block_d"], p["chunk"], N, elt) <= SXM.smem_per_block
            if N == 256:
                assert {p["states"] for p in points} == {8, 16}


def test_state_sizes_past_256_raise_with_the_limit():
    args = carry.ssm_inputs(*ssm_numpy(seed=96, S=8, D=32, N=257), device="cpu")
    with pytest.raises(ValueError, match=r"N=257 outside 1\.\.256"):
        ssm_mod.ssm_scan(*args, block_d=32, chunk=8, states=16)
    assert ssm_mod.N_MAX == 256
    assert "N >= 1 && N <= 256" in SOURCE.read_text()


def _kernel_reduction(NP: int, K: int, partial: np.ndarray):
    """The kernel's y sums of one group, lane by lane as the source does
    them: the reduce-scatter levels, then the butterfly over ``spread``
    lanes; returns {step: sum} of the storing lanes."""
    U = 32 // K
    tpc = NP // K
    levels = {1: 5, 2: 4, 4: 3, 8: 2, 16: 1}[K]
    p = [list(partial[g]) for g in range(tpc)]
    for lv in range(levels):
        if (tpc >> lv) > 1:
            o, half = tpc >> (lv + 1), U >> (lv + 1)
            sent = [[(p[g][i] if g & o else p[g][i + half]) for i in range(half)]
                    for g in range(tpc)]
            p = [[(p[g][i + half] if g & o else p[g][i]) + sent[g ^ o][i]
                  for i in range(half)] + p[g][half:] for g in range(tpc)]
    spread = tpc // U if tpc > U else 1
    m = 1 if tpc > U else U // tpc
    o = spread // 2
    while o >= 1:
        p = [[p[g][0] + p[g ^ o][0]] + p[g][1:] for g in range(tpc)]
        o //= 2
    stored = {}
    for g in range(tpc):
        if g % spread == 0:
            first = g // spread * m
            for i in range(m):
                assert first + i not in stored
                stored[first + i] = p[g][i]
    return stored


@pytest.mark.parametrize("NP,K", [(16, 1), (16, 4), (32, 2), (64, 2), (64, 4), (64, 16),
                                  (128, 4), (256, 8), (256, 16), (1, 1), (2, 2)])
def test_lane_reduction_stores_every_step_once(NP, K):
    U = 32 // K
    partial = np.random.default_rng(NP * 100 + K).standard_normal((NP // K, U))
    stored = _kernel_reduction(NP, K, partial)
    assert sorted(stored) == list(range(U))
    np.testing.assert_allclose([stored[s] for s in range(U)], partial.sum(0), rtol=1e-12)


def test_the_reduction_mirror_is_the_sources():
    """The mirror's lane mapping is the source's General instantiation's
    (any N); N a power of two up to 32 keeps the narrow one."""
    text = SOURCE.read_text()
    assert "const int spread = General && tpc > U ? tpc / U : 1;" in text
    assert "const int m = General && tpc > U ? 1 : U / tpc;" in text
    assert "const int lane_first = General ? g / spread * m : g * m;" in text
    assert "const bool stores = !General || g % spread == 0;" in text
    assert re.search(r"for \(int o = spread / 2; o >= 1; o /= 2\) p\[0\] \+= "
                     r"__shfl_xor_sync\(0xffffffffu, p\[0\], o\);", text)
    assert "const bool general = a.N != a.np || a.np > 32;" in text
