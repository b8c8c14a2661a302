"""Plain PyTorch version of the Seism3D ``update_stress`` kernel.

It repeats the JAX package's ``stress_ref`` op for op, so on the CPU it
rounds as the JAX oracle does and on the card as the CUDA kernel does.

Inputs: the 17 fields of ``INPUT_NAMES``, each (nk, nj, ni) f32.
Output: the 6 updated stress components of ``OUTPUT_NAMES``, (nk, nj, ni) f32.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

DT = 5.0e-3

INPUT_NAMES = (
    "Sxx", "Syy", "Szz", "Sxy", "Sxz", "Syz",
    "dxVx", "dyVy", "dzVz", "dxVy", "dyVx", "dxVz", "dzVx", "dyVz", "dzVy",
    "lam", "rig",
)
OUTPUT_NAMES = ("Sxx", "Syy", "Szz", "Sxy", "Sxz", "Syz")


def stress_ref(inp: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    rl, rm = inp["lam"], inp["rig"]
    rm2 = 2.0 * rm
    rlrm2 = rl + rm2
    d3 = inp["dxVx"] + inp["dyVy"] + inp["dzVz"]
    return {
        "Sxx": inp["Sxx"] + DT * (rlrm2 * d3 - rm2 * (inp["dyVy"] + inp["dzVz"])),
        "Syy": inp["Syy"] + DT * (rlrm2 * d3 - rm2 * (inp["dxVx"] + inp["dzVz"])),
        "Szz": inp["Szz"] + DT * (rlrm2 * d3 - rm2 * (inp["dxVx"] + inp["dyVy"])),
        "Sxy": inp["Sxy"] + DT * inp["rig"] * (inp["dxVy"] + inp["dyVx"]),
        "Sxz": inp["Sxz"] + DT * inp["rig"] * (inp["dxVz"] + inp["dzVx"]),
        "Syz": inp["Syz"] + DT * inp["rig"] * (inp["dyVz"] + inp["dzVy"]),
    }


def make_inputs(
    generator: Optional[torch.Generator] = None,
    dims=(256, 256, 256),
    device="cuda",
) -> Dict[str, torch.Tensor]:
    """Standard-normal fields from ``generator``, made on ``device``; the
    Lamé parameters ``lam`` and ``rig`` are ``1 + |N(0, 1)|``."""
    out = {}
    for name in INPUT_NAMES:
        x = torch.randn(dims, generator=generator, dtype=torch.float32, device=device)
        if name in ("lam", "rig"):
            x = 1.0 + x.abs()
        out[name] = x
    return out
