"""Plain PyTorch versions of the loop-nest kernel's two bodies, as the JAX
package's apps define them (``src/repro/apps/gkv.py`` ``exb_body``,
``src/repro/apps/seism3d.py`` ``update_stress_body``), op for op.

Both are elementwise over dicts of tensors of one shape, so they run on a
whole domain (the oracle), on blocks of a variant's launch shape
(:func:`repro_torch.core.exchange.run_plain`) or on CUDA tensors beside the
kernel alike.
"""
from __future__ import annotations

from typing import Dict

import torch

CS1 = 0.8775825618903728  # cos(0.5); any O(1) physics constant works
CEF = 1.0 / (2 * 128 * 2 * 64)  # 1/(2nx * 2ny) FFT back-normalization
DT = 5.0e-3

# the kernel's argument order
GKV_FIELDS = ("wkdf1", "wkdf2", "wkexw", "wkeyw", "wkbxw", "wkbyw", "vl")
STRESS = ("Sxx", "Syy", "Szz", "Sxy", "Sxz", "Syz")
DERIVS = ("dxVx", "dyVy", "dzVz", "dxVy", "dyVx", "dxVz", "dzVx", "dyVz", "dzVy")
SEISM_FIELDS = STRESS + DERIVS + ("lam", "rig")


def exb_body(inp: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """GKV's E×B update: the component-wise (not complex) products of two
    real fields packed into one complex array; returns ``wkdf1``."""
    ey = inp["wkeyw"] - CS1 * inp["vl"] * inp["wkbyw"]
    ex = inp["wkexw"] - CS1 * inp["vl"] * inp["wkbxw"]
    re = inp["wkdf1"].real * ey.real - inp["wkdf2"].real * ex.real
    im = inp["wkdf1"].imag * ey.imag - inp["wkdf2"].imag * ex.imag
    return {"wkdf1": torch.complex(re, im) * CEF}


def update_stress_body(inp: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Seism3D's stress update: six components from nine velocity
    derivatives and the two Lamé fields."""
    rl = inp["lam"]
    rm = inp["rig"]
    rm2 = 2.0 * rm
    rlrm2 = rl + rm2
    d3 = inp["dxVx"] + inp["dyVy"] + inp["dzVz"]
    return {
        "Sxx": inp["Sxx"] + DT * (rlrm2 * d3 - rm2 * (inp["dyVy"] + inp["dzVz"])),
        "Syy": inp["Syy"] + DT * (rlrm2 * d3 - rm2 * (inp["dxVx"] + inp["dzVz"])),
        "Szz": inp["Szz"] + DT * (rlrm2 * d3 - rm2 * (inp["dxVx"] + inp["dyVy"])),
        "Sxy": inp["Sxy"] + DT * rm * (inp["dxVy"] + inp["dyVx"]),
        "Sxz": inp["Sxz"] + DT * rm * (inp["dxVz"] + inp["dzVx"]),
        "Syz": inp["Syz"] + DT * rm * (inp["dyVz"] + inp["dzVy"]),
    }
