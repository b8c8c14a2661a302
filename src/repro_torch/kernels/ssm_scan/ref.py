"""Plain PyTorch version of the Mamba-1 selective-scan kernel.

It repeats the JAX package's ``ssm_scan_ref`` op for op, one time step
after another, over already-projected per-step quantities:

    h_t = exp(dt_t ⊗ A) ⊙ h_{t-1} + (dt_t · x_t) ⊗ B_t
    y_t = h_t · C_t + D ⊙ x_t

The state h is (B, D, N) float32; the (S, D, N) decay is never stored.
Both it and the backward (:func:`ssm_scan_bwd_ref`) compute in float32, or
in float64 for float64 inputs (``torch.autograd.gradcheck``).
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
    wd = work_dtype(x.dtype)
    xf, dtf, Bf, Cf, Af = (t.to(wd) for t in (x, dt, Bc, Cc, A))
    h = torch.zeros((Bsz, Dd, N), dtype=wd, device=x.device)
    ys = torch.empty((Bsz, S, Dd), dtype=wd, device=x.device)
    for t in range(S):
        x_t, dt_t = xf[:, t], dtf[:, t]
        decay = torch.exp(dt_t[..., None] * Af)
        h = decay * h + (dt_t * x_t)[..., None] * Bf[:, t, None, :]
        ys[:, t] = (h * Cf[:, t, None, :]).sum(-1)
    y = (ys + xf * D.to(wd)).to(x.dtype)
    return (y, h) if final_state else y


def work_dtype(dtype: torch.dtype) -> torch.dtype:
    """float32, or float64 for float64 inputs."""
    return torch.promote_types(dtype, torch.float32)


def ssm_scan_bwd_ref(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bc: torch.Tensor,
    Cc: torch.Tensor, D: torch.Tensor,
    dy: torch.Tensor,                   # (B, S, D)  the gradient of y
    dh: Optional[torch.Tensor] = None,  # (B, D, N)  of the final state, or none
) -> Tuple[torch.Tensor, ...]:
    """(dx, ddt, dA, dBc, dCc, dD), each in its input's dtype: the
    gradient of :func:`ssm_scan_ref` as an explicit reverse-time scan of
    the state's adjoint g_t = ∂L/∂h_t (not autograd).  The states h_t are
    recomputed forward and kept, (S + 1, B, D, N); then, from the last step
    back, with ``carry`` = exp(dt_{t+1} ⊗ A) ⊙ g_{t+1} (``dh`` before the
    last step)::

        g_t    = dy_t ⊗ C_t + carry
        dA    += Σ_b g_t ⊙ h_{t-1} ⊙ decay_t · dt_t
        ddt_t  = Σ_n g_t ⊙ (A ⊙ decay_t ⊙ h_{t-1} + x_t ⊗ B_t)
        dx_t   = dt_t · Σ_n g_t ⊙ B_t + D · dy_t
        dB_t   = Σ_d g_t · dt_t x_t,     dC_t = Σ_d h_t · dy_t
        dD     = Σ_{b,t} dy · x
    """
    Bsz, S, Dd = x.shape
    N = A.shape[1]
    wd = work_dtype(x.dtype)
    xf, dtf, Bf, Cf, Af, dyf = (t.to(wd) for t in (x, dt, Bc, Cc, A, dy))
    hs = torch.zeros((S + 1, Bsz, Dd, N), dtype=wd, device=x.device)  # hs[t + 1] = h_t
    for t in range(S):
        decay = torch.exp(dtf[:, t, :, None] * Af)
        hs[t + 1] = decay * hs[t] + (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :]
    carry = (torch.zeros((Bsz, Dd, N), dtype=wd, device=x.device) if dh is None
             else dh.to(wd).clone())
    dx, ddt = torch.empty_like(xf), torch.empty_like(xf)
    dB, dC = torch.empty_like(Bf), torch.empty_like(Cf)
    dA = torch.zeros((Dd, N), dtype=wd, device=x.device)
    for t in reversed(range(S)):
        dt_t, x_t, dy_t = dtf[:, t], xf[:, t], dyf[:, t]
        decay = torch.exp(dt_t[..., None] * Af)
        g = dy_t[..., None] * Cf[:, t, None, :] + carry
        ghe = g * hs[t] * decay
        dA += (ghe * dt_t[..., None]).sum(0)
        s_b = (g * Bf[:, t, None, :]).sum(-1)
        ddt[:, t] = (ghe * Af).sum(-1) + x_t * s_b
        dx[:, t] = dt_t * s_b + D.to(wd) * dy_t
        dB[:, t] = (g * (dt_t * x_t)[..., None]).sum(1)
        dC[:, t] = (hs[t + 1] * dy_t[..., None]).sum(1)
        carry = decay * g
    dD = (dyf * xf).sum((0, 1))
    return (dx.to(x.dtype), ddt.to(dt.dtype), dA.to(A.dtype), dB.to(Bc.dtype),
            dC.to(Cc.dtype), dD.to(D.dtype))


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
