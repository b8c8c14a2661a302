"""Plain PyTorch version of the Mamba-1 selective-scan kernel.

It repeats the JAX package's ``ssm_scan_ref`` op for op, one time step
after another, over already-projected per-step quantities:

    h_t = exp(dt_t ⊗ A) ⊙ h_{t-1} + (dt_t · x_t) ⊗ B_t
    y_t = h_t · C_t + D ⊙ x_t

The state h is (B, D, N) float32; the (S, D, N) decay is never stored.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def ssm_scan_ref(
    x: torch.Tensor,   # (B, S, D)   post-conv, post-silu activations
    dt: torch.Tensor,  # (B, S, D)   softplus'd step sizes
    A: torch.Tensor,   # (D, N)      negative decay rates
    Bc: torch.Tensor,  # (B, S, N)
    Cc: torch.Tensor,  # (B, S, N)
    D: torch.Tensor,   # (D,)
    final_state: bool = False,
):
    """y, or ``(y, h)`` with ``final_state``: h the state after the last
    step, (B, D, N) float32."""
    Bsz, S, Dd = x.shape
    N = A.shape[1]
    xf, dtf, Bf, Cf = x.float(), dt.float(), Bc.float(), Cc.float()
    h = torch.zeros((Bsz, Dd, N), dtype=torch.float32, device=x.device)
    ys = torch.empty((Bsz, S, Dd), dtype=torch.float32, device=x.device)
    for t in range(S):
        x_t, dt_t = xf[:, t], dtf[:, t]
        decay = torch.exp(dt_t[..., None] * A)
        h = decay * h + (dt_t * x_t)[..., None] * Bf[:, t, None, :]
        ys[:, t] = (h * Cf[:, t, None, :]).sum(-1)
    y = (ys + xf * D).to(x.dtype)
    return (y, h) if final_state else y


def make_inputs(
    generator: Optional[torch.Generator] = None, B=1, S=2048, D=8192, N=16,
    device="cuda",
) -> Tuple[torch.Tensor, ...]:
    """(x, dt, A, Bc, Cc, D) as the JAX ``make_inputs`` draws them:
    dt = softplus(N(0,1) - 1), A = -exp(N(0,1) / 2), the rest N(0,1)."""

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32, device=device)

    x = normal(B, S, D)
    dt = torch.logaddexp(normal(B, S, D) - 1.0, torch.zeros((), device=device))
    A = -torch.exp(normal(D, N) * 0.5)
    Bc = normal(B, S, N)
    Cc = normal(B, S, N)
    Dp = normal(D)
    return x, dt, A, Bc, Cc, Dp
