"""Plain PyTorch version of the GKV exb kernel (split re/im layout).

It repeats the JAX package's ``exb_ref`` op for op, so on the CPU it
rounds as the JAX oracle does and on the card as the CUDA kernel does.

Inputs (C-order):
    df1_re/df1_im/df2_re/df2_im : (iv, iz, mx, my) f32
    ex_re/ex_im/ey_re/ey_im/bx_re/bx_im/by_re/by_im : (iz, mx, my) f32
    vl : (iv,) f32
Output: out_re/out_im : (iv, iz, mx, my) f32
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

CS1 = 0.8775825618903728
CEF = 1.0 / (2 * 128 * 2 * 64)

NAMES4 = ("df1_re", "df1_im", "df2_re", "df2_im")
NAMES3 = ("ex_re", "ex_im", "ey_re", "ey_im", "bx_re", "bx_im", "by_re", "by_im")


def exb_ref(inp: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    vl = inp["vl"][:, None, None, None]  # (iv,1,1,1)
    ey_re = inp["ey_re"][None] - CS1 * vl * inp["by_re"][None]
    ey_im = inp["ey_im"][None] - CS1 * vl * inp["by_im"][None]
    ex_re = inp["ex_re"][None] - CS1 * vl * inp["bx_re"][None]
    ex_im = inp["ex_im"][None] - CS1 * vl * inp["bx_im"][None]
    out_re = (inp["df1_re"] * ey_re - inp["df2_re"] * ex_re) * CEF
    out_im = (inp["df1_im"] * ey_im - inp["df2_im"] * ex_im) * CEF
    return out_re, out_im


def make_inputs(
    generator: Optional[torch.Generator] = None,
    dims=(16, 16, 128, 65),
    device="cuda",
) -> Dict[str, torch.Tensor]:
    """Standard-normal inputs from ``generator``, made on ``device``."""
    iv, iz, mx, my = dims

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=device)

    out = {n: normal(iv, iz, mx, my) for n in NAMES4}
    out.update({n: normal(iz, mx, my) for n in NAMES3})
    out["vl"] = normal(iv)
    return out
