"""Seism3D / ppOpen-APPL/FDM ``update_stress`` — the paper's §IV target, on
the card.

``update_stress`` advances the six stress components of the 3-D
velocity–stress staggered-grid FDM by one time step from the nine velocity
derivative fields and the Lamé fields (:func:`update_stress_body`).  It is
elementwise, so it brackets as a 3-deep (k, j, i) AT loop nest; each
(variant, degree) is a launch shape of the hand-written loop-nest kernel
(``csrc/loop_nest.cu``).  The paper tunes only the thread count for it; the
full (variant × degree) space is exposed, and the Fig. 12 degree-switch
experiment runs on it.

:data:`SEISM_DIMS` is the JAX package's grid (64³, 24 MB: it sits in the
H100's 50 MB L2); :data:`CARD_DIMS` is one card's subdomain, the ``stress``
kernel's grid (256³, 1.544 GB).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from ..core import ATRegion, LoopNest
from ..kernels.loop_nest import loop_nest
from ..kernels.loop_nest.ref import DERIVS, DT, STRESS, update_stress_body  # noqa: F401
from . import degrees as app_degrees

# A NUMA-node-scale grid; the FX100 experiment ran 8 MPI ranks x 8 nodes.
SEISM_DIMS: Tuple[Tuple[str, int], ...] = (("k", 64), ("j", 64), ("i", 64))
CARD_DIMS: Tuple[Tuple[str, int], ...] = (("k", 256), ("j", 256), ("i", 256))


def make_inputs(
    seed: int = 0, dims: Sequence[Tuple[str, int]] = SEISM_DIMS, device="cuda",
) -> Dict[str, torch.Tensor]:
    """Standard-normal fields from a ``torch.Generator`` seeded with
    ``seed``; the Lamé fields ``1 + |x|`` (positive moduli)."""
    shape = tuple(n for _, n in dims)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name in list(STRESS) + list(DERIVS) + ["lam", "rig"]:
        x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        out[name] = 1.0 + x.abs() if name in ("lam", "rig") else x
    return out


def stress_nest(dims: Sequence[Tuple[str, int]] = SEISM_DIMS) -> LoopNest:
    return LoopNest("seism3d_update_stress", dims, update_stress_body, kernel=loop_nest.stress)


def stress_region(
    dims: Sequence[Tuple[str, int]] = SEISM_DIMS,
    degrees: Optional[Sequence[int]] = None,
) -> ATRegion:
    """The 6 loop variants × degrees; the degrees default to
    :func:`repro_torch.apps.degrees` of the local card."""
    return stress_nest(dims).at_region(degrees=degrees or app_degrees())


def reference(inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return update_stress_body(inputs)


def flops_per_point() -> int:
    """1 (rm2) + 1 (rlrm2) + 2 (d3) + 3*(2+1+1+1) + 3*(1+1+1) = 28."""
    return 28


def bytes_per_point() -> int:
    """Bytes one point moves: 17 float32 fields read, 6 written."""
    return 4 * (17 + 6)
