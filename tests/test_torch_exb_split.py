"""The exb kernel's third tunable, ``split``, as far as the CPU can see it.

The kernel (``csrc/exb.cu``) runs only on the card, where ``chip_smoke.py``
holds every emitted point against the plain version.  Here: the emitted
space holds ``split`` (a "pieces" dim: the CTA count grows with it) up to
a piece of 64 elements and 8 CTAs an SM, every point passes the wrapper's
checks, and the plain version, which every ``split`` runs on the CPU,
matches the JAX kernel (Pallas in interpret mode) at a plane that is not a
multiple of 4 floats, the one the kernel walks in single floats.
"""
from __future__ import annotations

from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

from repro.kernels.exb import ops as jax_exb_ops
from repro_torch import carry
from repro_torch.core import pp_key
from repro_torch.core.arch import from_properties
from repro_torch.core.emit import TileDim, TilePolicy
from repro_torch.kernels.exb import exb as exb_mod
from repro_torch.kernels.exb import ops as exb_ops
from repro_torch.kernels.exb.ref import NAMES3, NAMES4
from test_torch_arch import props
from test_torch_kernels import assert_close, exb_numpy

SXM = from_properties(props("NVIDIA H100 80GB HBM3"))
SOURCE = Path(exb_mod.__file__).resolve().parents[2] / "csrc" / "exb.cu"


def _meta_inputs(dims):
    iv, iz, mx, my = dims
    out = {n: torch.empty(iv, iz, mx, my, device="meta") for n in NAMES4}
    out.update({n: torch.empty(iz, mx, my, device="meta") for n in NAMES3})
    out["vl"] = torch.empty(iv, device="meta")
    return out


@pytest.mark.parametrize("dims", [(16, 16, 128, 65), (4, 8, 16, 64), (2, 4, 3, 5)])
def test_every_point_passes_the_wrapper_checks(dims):
    region = exb_ops.exb_region(dims=dims, arch=SXM)
    inp = _meta_inputs(dims)
    for p in region.space.points():
        assert set(p) == {"block_iv", "block_iz", "split"}
        exb_mod._check_inputs(inp, p["block_iv"], p["block_iz"], p["split"])


@pytest.mark.parametrize("plane,splits", [
    (128 * 65, (1, 2, 4, 8, 16, 32)),        # 2080 float4s: pieces of >= 64
    (16 * 64, (1, 2, 4)),                    # 256 float4s
    (3 * 5, (1,)),                           # 15 floats: one piece
    (8321, (1, 2, 4, 8, 16, 32, 64, 128)),   # 8321 floats, the ladder's 8 largest
])
def test_split_ladder_follows_the_plane(plane, splits):
    assert exb_mod.plane_elements(plane) == (plane // 4 if plane % 4 == 0 else plane)
    region = exb_ops.exb_region(dims=(1, 1, 1, plane), arch=SXM)
    assert sorted({p["split"] for p in region.space.points()}) == list(splits)


def test_split_multiplies_the_ctas_and_is_capped_by_the_sms():
    region = exb_ops.exb_region(arch=SXM)
    for p in region.space.points():
        hint = region.hints[pp_key(p)]
        ctas = (16 // p["block_iv"]) * (16 // p["block_iz"]) * p["split"]
        assert hint["programs"] == ctas
        assert hint["pad_factor"] == 1.0
        assert p["split"] == 1 or ctas <= exb_ops.MAX_CTAS_PER_SM * SXM.sm_count
    assert max(region.hints[pp_key(p)]["programs"] for p in region.space.points()) > 256


def test_pieces_dim_counts_its_value_not_a_tile():
    policy = TilePolicy(
        kernel="pieces_demo",
        dims=lambda bp: (TileDim("block", 8, semantic="grid"),
                         TileDim("split", 100, semantic="pieces", min_tile=1, max_tile=4,
                                 allow_padding=True, pow2_only=True)),
        vmem_model=lambda bp, p: 0,
    )
    emitted = policy.emit(SXM, {})
    assert sorted({p["split"] for p in emitted.space.points()}) == [1, 2, 4]
    for p in emitted.space.points():
        assert emitted.hints[pp_key(p)]["programs"] == (8 // p["block"]) * p["split"]
    with pytest.raises(ValueError, match="semantic"):
        TileDim("x", 4, semantic="rows")


@pytest.mark.parametrize("point", [(1, 1, 1), (1, 2, 2), (2, 4, 4), (2, 1, 64)])
def test_plain_version_matches_jax_exb_at_an_odd_plane(point):
    """A (3, 5) plane: 15 floats, no multiple of 4; DEFAULT_TOL float32."""
    arrays = exb_numpy(seed=17, dims=(2, 4, 3, 5))
    biv, biz, split = point
    ref_re, ref_im = jax_exb_ops.exb({k: jnp.asarray(v) for k, v in arrays.items()},
                                     block_iv=biv, block_iz=biz)
    exb_mod.counter.reset()
    out_re, out_im = exb_mod.exb(carry.exb_inputs(arrays, device="cpu"),
                                 block_iv=biv, block_iz=biz, split=split)
    assert (exb_mod.counter.launches, exb_mod.counter.plain_calls) == (0, 1)
    assert_close(out_re, ref_re, "float32", f"exb re {point}")
    assert_close(out_im, ref_im, "float32", f"exb im {point}")


def test_split_below_one_is_refused():
    inp = carry.exb_inputs(exb_numpy(seed=18, dims=(2, 2, 3, 5)), device="cpu")
    with pytest.raises(ValueError, match="split"):
        exb_mod.exb(inp, block_iv=1, block_iz=1, split=0)


def test_source_walks_float4_or_float_elements():
    text = SOURCE.read_text()
    assert "exb_kernel<float4>" in text and "exb_kernel<float>" in text
    assert "__fmul_rn" in text and "__fsub_rn" in text  # the plain version's rounding
