"""The paper's apps in the port (``repro_torch.apps``, ``core.exchange``,
``core.degree``) against the JAX package's, on the CPU.

The same inputs (the JAX ``make_inputs``, carried through numpy) go through
the JAX ``LoopNest.variant_fn`` and the port's, whose CPU route runs the
plain version with the JAX semantics (the last chunk edge-padded); every
GKV variant at degrees 1, 3 and 32, every Seism3D variant at degree 8,
within ``DEFAULT_TOL`` float32.  The kernel runs only on the card, where
``chip_smoke.py`` holds every (variant, degree) of both apps against the
plain body.  Also: the three cases of ``tests/test_exchange_semantics.py``
on the port, the DegreeController's switch counts against the JAX one's,
the degrees the apps tune over, and the CUDA-only paths refusing CPU
tensors.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformance import DEFAULT_TOL
from repro.apps import gkv as jax_gkv
from repro.apps import seism3d as jax_seism
from repro.core import DegreeController as JaxDegreeController
from repro.core import ExchangeVariant as JaxVariant
from repro.core import LoopNest as JaxLoopNest
from repro_torch import carry
from repro_torch.apps import degrees as app_degrees
from repro_torch.apps import gkv, paper_figures, seism3d
from repro_torch.core import (
    DegreeController, ExchangeVariant, GKV_FIGURE_OF_VARIANT, LoopNest,
    enumerate_exchange_variants,
)
from repro_torch.core.arch import from_properties
from repro_torch.kernels.loop_nest import loop_nest as ln_mod
from test_torch_arch import props

GKV_SMALL = (("iv", 4), ("iz", 4), ("mx", 16), ("my", 9))
SEISM_SMALL = (("k", 8), ("j", 8), ("i", 8))
RTOL, ATOL = DEFAULT_TOL["float32"]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy()  # complex64 stays complex: both parts compared


@pytest.fixture(scope="module")
def gkv_case():
    arrays = jax_gkv.make_inputs(jax.random.PRNGKey(3), GKV_SMALL)
    return arrays, carry.gkv_inputs({k: np.asarray(v) for k, v in arrays.items()}, device="cpu")


@pytest.mark.parametrize("variant", [(v.m, v.j) for v in enumerate_exchange_variants(4)])
def test_gkv_variants_match_jax(gkv_case, variant):
    arrays, inputs = gkv_case
    jax_nest, nest = jax_gkv.exb_nest(GKV_SMALL), gkv.exb_nest(GKV_SMALL)
    ln_mod.counters["gkv"].reset()
    for degree in (1, 3, 32):
        ref = jax_nest.variant_fn(JaxVariant(*variant), degree)(arrays)["wkdf1"]
        out = nest.variant_fn(ExchangeVariant(*variant), degree)(inputs)["wkdf1"]
        assert out.dtype == torch.complex64 and tuple(out.shape) == ref.shape
        np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=RTOL, atol=ATOL,
                                   err_msg=f"gkv {variant} degree {degree}")
    assert (ln_mod.counters["gkv"].launches, ln_mod.counters["gkv"].plain_calls) == (0, 3)


def test_seism3d_variants_match_jax():
    arrays = jax_seism.make_inputs(jax.random.PRNGKey(4), SEISM_SMALL)
    inputs = carry.seism_inputs({k: np.asarray(v) for k, v in arrays.items()}, device="cpu")
    jax_nest, nest = jax_seism.stress_nest(SEISM_SMALL), seism3d.stress_nest(SEISM_SMALL)
    for v in enumerate_exchange_variants(3):
        ref = jax_nest.variant_fn(JaxVariant(v.m, v.j), 8)(arrays)
        out = nest.variant_fn(v, 8)(inputs)
        assert set(out) == set(ref) == set(seism3d.STRESS)
        for name in out:
            np.testing.assert_allclose(_np(out[name]), np.asarray(ref[name]), rtol=RTOL,
                                       atol=ATOL, err_msg=f"seism3d {v} {name}")


def test_bodies_are_the_jax_bodies_on_the_whole_domain(gkv_case):
    arrays, inputs = gkv_case
    np.testing.assert_allclose(_np(gkv.reference(inputs)["wkdf1"]),
                               np.asarray(jax_gkv.reference(arrays)["wkdf1"]),
                               rtol=RTOL, atol=ATOL)
    assert (gkv.CS1, gkv.CEF, seism3d.DT) == (jax_gkv.CS1, jax_gkv.CEF, jax_seism.DT)
    assert gkv.flops_per_point() == jax_gkv.flops_per_point()
    assert seism3d.flops_per_point() == jax_seism.flops_per_point()
    assert gkv.GKV_DIMS == jax_gkv.GKV_DIMS and seism3d.SEISM_DIMS == jax_seism.SEISM_DIMS


# -- tests/test_exchange_semantics.py, on the port ---------------------------

def _nest():
    return LoopNest("t", [("a", 4), ("b", 6), ("c", 5)], lambda x: x * 3.0 - 1.0)


def test_degree_beyond_loop_length_idles():
    """Degree > P must equal degree == P exactly (threads beyond P idle)."""
    nest = _nest()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 6, 5), np.float32))
    v = ExchangeVariant(m=3, j=1)  # parallel loop = a, length 4
    assert torch.equal(nest.variant_fn(v, 4)(x), nest.variant_fn(v, 64)(x))


def test_uneven_degree_padding_is_masked():
    """P=5 split 2 ways -> chunks of 3 with 1 padded slot; the pad never
    leaks into outputs (edge-replicated input, sliced output)."""
    nest = LoopNest("t", [("c", 5)], lambda x: 1.0 / (x + 10.0))
    x = torch.arange(5, dtype=torch.float32)
    ref = nest.reference(x)
    for d in (2, 3, 4):
        np.testing.assert_allclose(nest.variant_fn(ExchangeVariant(1, 1), d)(x), ref,
                                   rtol=1e-6)


def test_region_joint_space_size():
    region = _nest().at_region(degrees=(1, 2, 4))
    assert region.space.size() == 6 * 3  # N(N+1)/2 variants x degrees


def test_variants_and_figures_are_the_jax_ones():
    from repro.core import GKV_FIGURE_OF_VARIANT as JAX_FIGURES
    from repro.core import enumerate_exchange_variants as jax_enumerate

    for n in (1, 3, 4):
        assert [(v.m, v.j) for v in enumerate_exchange_variants(n)] == [
            (v.m, v.j) for v in jax_enumerate(n)]
    assert GKV_FIGURE_OF_VARIANT == JAX_FIGURES
    names = ("iv", "iz", "mx", "my")
    for v in enumerate_exchange_variants(4):
        assert v.label(names) == JaxVariant(v.m, v.j).label(names)
    with pytest.raises(ValueError):
        ExchangeVariant(2, 3)


# -- the degree protocol -----------------------------------------------------

def test_degree_controller_switches_as_the_jax_one():
    ours, theirs = DegreeController(32), JaxDegreeController(32)
    for ctl in (ours, theirs):
        ctl.set_tuned("update_stress", 8)
        ctl.set_tuned("exb", 32)
    seen = []
    for name in ("update_stress", "exb", "update_stress", "untuned", "update_stress"):
        for ctl in (ours, theirs):
            with ctl.region(name) as d:
                seen.append((type(ctl).__module__.split(".")[0], d, ctl.current))
        assert ours.switch_count == theirs.switch_count
        assert ours.current == theirs.current == 32
    assert ours.switch_count == 6
    assert [s[1:] for s in seen[::2]] == [s[1:] for s in seen[1::2]]
    with pytest.raises(ValueError):
        ours.set_tuned("x", 33)


def test_app_degrees_are_the_papers_and_sms():
    sxm = from_properties(props("NVIDIA H100 80GB HBM3"))
    assert app_degrees(sxm) == (1, 2, 4, 8, 16, 32, 132, 264, 528)
    region = gkv.exb_region(GKV_SMALL, degrees=app_degrees(sxm))
    assert region.space.size() == 10 * 9
    assert seism3d.stress_region(SEISM_SMALL, degrees=(1, 8)).space.size() == 6 * 2


# -- inputs and the CUDA-only paths -----------------------------------------

def test_make_inputs_are_prebroadcast_and_seeded():
    a = gkv.make_inputs(7, GKV_SMALL, device="cpu")
    b = gkv.make_inputs(7, GKV_SMALL, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert set(a) == set(ln_mod.GKV_FIELDS)
    for name, t in a.items():
        assert tuple(t.shape) == (4, 4, 16, 9) and t.is_contiguous()
        assert t.dtype == (torch.float32 if name == "vl" else torch.complex64)
    assert torch.equal(a["wkexw"][0], a["wkexw"][3])         # (iz, mx, my) only
    assert torch.equal(a["vl"][1, 0, 0, 0].expand(4, 16, 9), a["vl"][1])  # iv only
    s = seism3d.make_inputs(7, SEISM_SMALL, device="cpu")
    assert set(s) == set(ln_mod.SEISM_FIELDS)
    assert bool((s["lam"] >= 1).all()) and bool((s["rig"] >= 1).all())


def test_cuda_paths_refuse_cpu_tensors():
    from repro_torch.core import launch_shape

    inputs = gkv.make_inputs(0, GKV_SMALL, device="cpu")
    ls = launch_shape((4, 4, 16, 9), ExchangeVariant(4, 2), 3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ln_mod.exb_cuda(inputs, ls)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ln_mod.stress_cuda(seism3d.make_inputs(0, SEISM_SMALL, device="cpu"),
                           launch_shape((8, 8, 8), ExchangeVariant(3, 1), 2))
    with pytest.raises(ValueError, match="on the card"):
        paper_figures.fig11(gkv.exb_nest(GKV_SMALL), inputs)


def test_wrappers_reject_what_the_kernel_does_not_take():
    from repro_torch.core import launch_shape

    inputs = gkv.make_inputs(0, GKV_SMALL, device="cpu")
    ls = launch_shape((4, 4, 16, 9), ExchangeVariant(4, 2), 3)
    with pytest.raises(ValueError, match="lack"):
        ln_mod.exb({k: v for k, v in inputs.items() if k != "vl"}, ls)
    with pytest.raises(ValueError, match="complex64"):
        ln_mod.exb(dict(inputs, wkdf2=inputs["wkdf2"].real.contiguous()), ls)
    with pytest.raises(ValueError, match="does not cover"):
        ln_mod.exb(inputs, launch_shape((4, 4, 16, 8), ExchangeVariant(4, 2), 3))
    stress = seism3d.make_inputs(0, SEISM_SMALL, device="cpu")
    with pytest.raises(ValueError, match="not"):
        ln_mod.stress(dict(stress, lam=stress["lam"][:4]),
                      launch_shape((8, 8, 8), ExchangeVariant(3, 1), 2))
