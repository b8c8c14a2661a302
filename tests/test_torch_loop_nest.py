"""The loop-nest kernel's launch shapes (``repro_torch.core.exchange``,
``csrc/loop_nest.cu``), as far as the CPU can see them.

``launch_shape`` must be the JAX ``LoopNest.variant_fn``'s own arithmetic:
its outer length, chunk count, chunk and inner extent (read from the JAX
candidate's closure), for every variant and every degree up to 528 on both
apps' domains.  And a mirror of the kernel's walk (one launch per outer
iteration, CTA c over its ``chunk`` directive iterations times the inner
extent, ``kThreads`` threads striding over them, as the source's ``walk``
and ``run_launches`` do) must cover every element of the domain exactly once,
also at degrees that do not divide the directive loop and past it.  The
kernel itself runs only on the card, where ``chip_smoke.py`` holds every
(variant, degree) against the plain body.
"""
from __future__ import annotations

import math
import re
from pathlib import Path

import numpy as np
import pytest

from repro.apps import gkv as jax_gkv
from repro.apps import seism3d as jax_seism
from repro.core import ExchangeVariant as JaxVariant
from repro_torch.core import ExchangeVariant, enumerate_exchange_variants, launch_shape
from repro_torch.kernels.loop_nest import loop_nest as ln_mod

SOURCE = Path(ln_mod.__file__).resolve().parents[2] / "csrc" / "loop_nest.cu"
DEGREES = (1, 2, 3, 4, 7, 8, 16, 32, 65, 100, 132, 264, 528)
DOMAINS = {"gkv": (jax_gkv.GKV_DIMS, jax_gkv.exb_nest),
           "seism3d": (jax_seism.SEISM_DIMS, jax_seism.stress_nest),
           "seism3d 256^3": ((("k", 256), ("j", 256), ("i", 256)), jax_seism.stress_nest)}


def _threads() -> int:
    return int(re.search(r"constexpr int kThreads = (\d+);", SOURCE.read_text()).group(1))


def _jax_shape(nest, variant, degree):
    run = nest.variant_fn(JaxVariant(*variant), degree)
    cells = dict(zip(run.__code__.co_freevars, (c.cell_contents for c in run.__closure__)))
    return (cells["o_len"], cells["nchunks"], cells["chunk"], math.prod(cells["inner_shape"]),
            cells["par_len"])


@pytest.mark.parametrize("domain", sorted(DOMAINS))
def test_launch_shape_is_the_jax_variant_fns(domain):
    dims, make = DOMAINS[domain]
    nest = make(dims)
    lengths = tuple(n for _, n in dims)
    for v in enumerate_exchange_variants(len(lengths)):
        for degree in DEGREES:
            assert tuple(launch_shape(lengths, v, degree)) == _jax_shape(
                nest, (v.m, v.j), degree), (domain, v, degree)


def _walk(shape, threads: int) -> np.ndarray:
    """How often the kernel's walk touches each element: launch o at base
    o * per_launch, CTA c over [c per_cta, min((c + 1) per_cta,
    per_launch)), thread t at start + t, start + t + threads, ..."""
    launches, ctas, chunk, inner, par_len = shape
    per_cta, per_launch = chunk * inner, par_len * inner
    touched = np.zeros(launches * per_launch, np.int64)
    steps = -(-per_cta // threads)
    t = np.arange(threads)
    for c in range(ctas):
        start = c * per_cta
        end = min(start + per_cta, per_launch)
        e = (start + t[None, :] + threads * np.arange(steps)[:, None]).ravel()
        e = e[e < end]
        idx = (np.arange(launches)[:, None] * per_launch + e[None, :]).ravel()
        np.add.at(touched, idx, 1)
    return touched


@pytest.mark.parametrize("domain,degrees", [
    ("gkv", (1, 3, 32, 100, 528)),
    ("seism3d", (1, 7, 65, 528)),
    ("small", (1, 2, 3, 5, 6, 64)),
])
def test_the_kernels_walk_covers_every_element_once(domain, degrees):
    lengths = (4, 6, 5) if domain == "small" else tuple(n for _, n in DOMAINS[domain][0])
    threads = _threads()
    for v in enumerate_exchange_variants(len(lengths)):
        for degree in degrees:
            shape = launch_shape(lengths, v, degree)
            touched = _walk(shape, threads)
            assert touched.size == math.prod(lengths)
            assert (touched == 1).all(), (domain, v, degree)


def test_the_walk_mirror_is_the_sources():
    text = SOURCE.read_text()
    assert _threads() == 1024
    assert "const long long start = static_cast<long long>(blockIdx.x) * per_cta;" in text
    assert "const long long end = min(start + per_cta, per_launch);" in text
    assert ("for (long long e = start + threadIdx.x; e < end; e += kThreads) "
            "body(base + e);") in text
    assert re.search(r"for \(long long o = 0; o < launches; \+\+o\) \{\s*"
                     r"walk<Body><<<ctas, kThreads, 0, stream>>>\(body, o \* per_launch, "
                     r"per_cta, per_launch\);", text)


def test_the_extreme_launch_shapes():
    """GKV (4,4): 16·16·128 launches a call; Seism3D 256³ (3,3): 65,536;
    the directive on a 16-long loop never runs more than 16 CTAs."""
    assert launch_shape((16, 16, 128, 65), ExchangeVariant(4, 4), 1).launches == 32_768
    assert launch_shape((256, 256, 256), ExchangeVariant(3, 3), 528).launches == 65_536
    assert launch_shape((16, 16, 128, 65), ExchangeVariant(4, 1), 528).ctas == 16
    shape = launch_shape((16, 16, 128, 65), ExchangeVariant(4, 4), 32)
    assert (shape.ctas, shape.chunk, shape.inner) == (32, 3, 1)  # 65 = 21 x 3 + 2: 10 idle
    with pytest.raises(ValueError, match="exceeds nest depth"):
        launch_shape((4, 5), ExchangeVariant(3, 1), 2)
    with pytest.raises(ValueError, match="degree"):
        launch_shape((4, 5), ExchangeVariant(2, 1), 0)
