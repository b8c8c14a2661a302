"""Stress parity: the JAX package's kernel and the port's, on one input.

The same numpy inputs (``np.random.default_rng``) go through the JAX
wrapper (Pallas in interpret mode, as the JAX tests run it on the CPU) and
through the port's wrapper on CPU tensors, which runs the port's plain
PyTorch version.  Tolerance: ``tests/conformance.py``'s ``DEFAULT_TOL``
float32 ``(2e-4, 1e-5)``, the stress conformance case's.  The CUDA kernel
itself is checked against the same plain version on the card by
``chip_smoke.py``.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.stress import ops as jax_stress_ops
from repro_torch import carry
from repro_torch.core.arch import CPU_HOST
from repro_torch.kernels.stress import ops as stress_ops
from repro_torch.kernels.stress import stress as stress_mod
from repro_torch.kernels.stress.ref import INPUT_NAMES, OUTPUT_NAMES
from test_torch_kernels import assert_close

STRESS_DIMS = (8, 8, 16)     # the JAX conformance case's shape
SLICE_DIMS = (256, 256, 256)  # one card's subdomain, as chip_smoke.py runs it


def stress_numpy(seed: int, dims=STRESS_DIMS):
    rng = np.random.default_rng(seed)
    out = {}
    for name in INPUT_NAMES:
        x = rng.standard_normal(dims, np.float32)
        if name in ("lam", "rig"):
            x = 1.0 + np.abs(x)
        out[name] = x
    return out


def _meta_inputs(dims):
    """Full-size fields that hold no data: the checks read shapes alone."""
    return {n: torch.empty(dims, dtype=torch.float32, device="meta") for n in INPUT_NAMES}


@pytest.mark.parametrize("point", [(1, 1), (2, 4), (8, 8)])
def test_stress_matches_jax_kernel(point):
    arrays = stress_numpy(seed=31)
    bk, bj = point
    ref = jax_stress_ops.stress({k: jnp.asarray(v) for k, v in arrays.items()},
                                block_k=bk, block_j=bj)
    out = stress_mod.stress(carry.stress_inputs(arrays, device="cpu"),
                            block_k=bk, block_j=bj)
    assert tuple(out) == OUTPUT_NAMES
    for name in OUTPUT_NAMES:
        assert_close(out[name], ref[name], "float32", f"stress {name} {point}")


def test_cpu_tensors_take_the_plain_version_and_count_it():
    inp = carry.stress_inputs(stress_numpy(seed=32), device="cpu")
    stress_mod.counter.reset()
    stress_mod.stress(inp, block_k=2, block_j=2)
    assert (stress_mod.counter.launches, stress_mod.counter.plain_calls) == (0, 1)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    inp = carry.stress_inputs(stress_numpy(seed=33), device="cpu")
    with pytest.raises(ValueError, match="must divide"):
        stress_mod.stress(inp, block_k=3, block_j=1)
    with pytest.raises(ValueError, match="rig"):
        stress_mod.stress(dict(inp, rig=inp["rig"][:, :4]), block_k=1, block_j=1)
    with pytest.raises(ValueError, match="lam"):
        stress_mod.stress(dict(inp, lam=inp["lam"].double()), block_k=1, block_j=1)
    with pytest.raises(ValueError, match="missing"):
        stress_mod.stress({k: v for k, v in inp.items() if k != "dzVy"})
    with pytest.raises(ValueError, match="CUDA tensors"):
        stress_mod.stress_cuda(inp, block_k=1, block_j=1)


@pytest.mark.parametrize("dims", [SLICE_DIMS, (64, 64, 16), STRESS_DIMS])
def test_every_emitted_point_passes_the_wrapper_checks(dims):
    """The emitted space is exactly what the wrapper takes."""
    region = stress_ops.stress_region(dims=dims, arch=CPU_HOST)
    inp = _meta_inputs(dims)
    points = list(region.space.points())
    assert len(points) > 1
    for point in points:
        stress_mod._check_inputs(inp, point["block_k"], point["block_j"])
    if dims == SLICE_DIMS:
        assert len(points) == 64  # 8 x 8 tiles, 2 to 256 on each axis


def test_hint_puts_a_full_wave_first_at_the_slice_shape():
    """The prescreen's finals at 256³ each give every SM a CTA; the points
    that leave SMs idle (down to one CTA) rank below them."""
    nk, nj, _ = SLICE_DIMS
    region = stress_ops.stress_region(dims=SLICE_DIMS, arch=CPU_HOST)
    ctas = [(nk // p["block_k"]) * (nj // p["block_j"]) for p in region.space.points()]
    assert all(c >= CPU_HOST.sm_count for c in ctas[:5])
    assert ctas[-1] == 1


def test_traffic_counts_every_field_once():
    flops, bytes_ = stress_mod.traffic(*SLICE_DIMS)
    cells = 256.0 ** 3
    assert bytes_ == 4 * 23 * cells  # 17 fields read, 6 written
    assert flops == 30 * cells
    region = stress_ops.stress_region(dims=SLICE_DIMS, arch=CPU_HOST)
    assert all(h["bytes"] == bytes_ for h in region.hints.values())


def test_shape_class_keys_the_port_apart():
    arrays = stress_numpy(seed=34)
    jbp = jax_stress_ops.shape_class({k: jnp.asarray(v) for k, v in arrays.items()})
    tbp = stress_ops.shape_class(carry.stress_inputs(arrays, device="cpu"))
    assert jbp.fingerprint() != tbp.fingerprint()
    assert tbp["framework"] == "torch" and tbp["backend"] == "cpu"
    assert {k: tbp[k] for k in ("nk", "nj", "ni", "dtype")} == {
        k: jbp[k] for k in ("nk", "nj", "ni", "dtype")
    }


def test_carry_keeps_fields_and_values():
    arrays = stress_numpy(seed=35)
    inp = carry.stress_inputs(arrays, device="cpu")
    assert set(inp) == set(INPUT_NAMES)
    for name, a in arrays.items():
        assert inp[name].dtype == torch.float32 and inp[name].is_contiguous()
        np.testing.assert_array_equal(carry.to_numpy(inp[name]), a)
