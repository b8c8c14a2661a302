"""GKV ``exb_realspcal`` — the paper's §III/§V tuning target, on the card.

The Fortran original (paper Fig. 1) updates the E×B drift term of the
gyrokinetic Vlasov distribution in real space over the quadruple loop
(iv, iz, mx, my); its body is :func:`exb_body` (the component-wise products
of two real fields packed into one complex array, not a complex multiply).
The loop nest is bracketed as an AT region over the paper's 10 Exchange ×
LoopFusion variants and the degrees of :func:`repro_torch.apps.degrees`:
§V's joint space.  Each (variant, degree) is a launch shape of the
hand-written loop-nest kernel (``csrc/loop_nest.cu``).

Fields (C order ``(iv, iz, mx, my)``, every one pre-broadcast to it once,
outside any timed region, as the JAX package's ``make_inputs`` gives
them): ``wkdf1``, ``wkdf2`` and ``wkexw``, ``wkeyw``, ``wkbxw``, ``wkbyw``
(complex64; the last four vary over (iz, mx, my) only) and ``vl``
(float32, varies over iv only).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from ..core import ATRegion, LoopNest
from ..kernels.loop_nest import loop_nest
from ..kernels.loop_nest.ref import CEF, CS1, exb_body  # noqa: F401
from . import degrees as app_degrees

# Paper §III.C experimental domain.
GKV_DIMS: Tuple[Tuple[str, int], ...] = (
    ("iv", 16),
    ("iz", 16),
    ("mx", 128),
    ("my", 65),
)


def make_inputs(
    seed: int = 0, dims: Sequence[Tuple[str, int]] = GKV_DIMS, device="cuda",
) -> Dict[str, torch.Tensor]:
    """Standard-normal fields from a ``torch.Generator`` seeded with
    ``seed``, pre-broadcast to the full domain and contiguous."""
    shape = tuple(n for _, n in dims)
    iv, iz, mx, my = shape
    gen = torch.Generator(device=device).manual_seed(seed)

    def normal(*s):
        return torch.randn(s, generator=gen, dtype=torch.float32, device=device)

    def cplx(*s):
        return torch.complex(normal(*s), normal(*s))

    out = {"wkdf1": cplx(*shape), "wkdf2": cplx(*shape)}
    for name in ("wkexw", "wkeyw", "wkbxw", "wkbyw"):
        out[name] = cplx(iz, mx, my).expand(shape).contiguous()
    out["vl"] = normal(iv, 1, 1, 1).expand(shape).contiguous()
    return out


def exb_nest(dims: Sequence[Tuple[str, int]] = GKV_DIMS) -> LoopNest:
    return LoopNest("gkv_exb_realspcal", dims, exb_body, kernel=loop_nest.exb)


def exb_region(
    dims: Sequence[Tuple[str, int]] = GKV_DIMS,
    degrees: Optional[Sequence[int]] = None,
) -> ATRegion:
    """The paper's AT region: 10 loop variants × degrees (§V); the degrees
    default to :func:`repro_torch.apps.degrees` of the local card."""
    return exb_nest(dims).at_region(degrees=degrees or app_degrees())


def reference(inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The plain body on the whole domain."""
    return exb_body(inputs)


def flops_per_point() -> int:
    """Real FLOPs per domain point (for roofline napkin math).

    ey/ex: 2 complex scale+sub = 2*(2 mul + 2 sub) = 8 each -> 16
    re/im: 2 mul + 1 sub each -> 6;  final scale: 2.  Total 24.
    """
    return 24


def bytes_per_point() -> int:
    """Bytes one point moves: six complex64 fields and ``vl`` read, one
    complex64 written."""
    return 6 * 8 + 4 + 8
