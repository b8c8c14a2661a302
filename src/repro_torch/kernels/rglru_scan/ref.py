"""Plain PyTorch version of the RG-LRU scan kernel (post-gate quantities).

It repeats the JAX package's ``rglru_scan_ref`` op for op, one time step
after another:

    a_t = exp(-8 · r_t · softplus(-λ))
    h_t = a_t · h_{t-1} + sqrt(max(1 - a_t², 1e-12)) · (i_t · x_t)
    y_t = h_t

``softplus`` is ``logaddexp(x, 0)``, as ``jax.nn.softplus`` computes it:
``torch.nn.functional.softplus`` returns x itself above its threshold.
Both it and the backward (:func:`rglru_scan_bwd_ref`) compute in float32,
or in float64 for float64 inputs (``torch.autograd.gradcheck``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

C_FACTOR = 8.0


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` with no threshold, as ``jax.nn.softplus``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def rglru_scan_ref(
    x: torch.Tensor,    # (B, S, W)  conv'd inputs
    r: torch.Tensor,    # (B, S, W)  recurrence gate, in (0, 1)
    i: torch.Tensor,    # (B, S, W)  input gate, in (0, 1)
    lam: torch.Tensor,  # (W,)       Λ parameter
) -> torch.Tensor:
    wd = work_dtype(x.dtype)
    softplus_neg_lam = softplus(-lam.to(wd))
    B, S, W = x.shape
    h = torch.zeros((B, W), dtype=wd, device=x.device)
    ys = torch.empty((B, S, W), dtype=wd, device=x.device)
    xf, rf, i_f = x.to(wd), r.to(wd), i.to(wd)
    for t in range(S):
        a = torch.exp(-C_FACTOR * rf[:, t] * softplus_neg_lam)
        h = a * h + torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i_f[:, t] * xf[:, t])
        ys[:, t] = h
    return ys.to(x.dtype)


def work_dtype(dtype: torch.dtype) -> torch.dtype:
    """float32, or float64 for float64 inputs."""
    return torch.promote_types(dtype, torch.float32)


def rglru_scan_bwd_ref(
    x: torch.Tensor, r: torch.Tensor, i: torch.Tensor, lam: torch.Tensor,
    dy: torch.Tensor,  # (B, S, W)  the gradient of y
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dr, di, dlam), each in its input's dtype: the gradient of
    :func:`rglru_scan_ref` as an explicit reverse recurrence (not
    autograd).  h is recomputed forward and kept; then, with a_{S} g_{S} = 0::

        g_t  = dy_t + a_{t+1} g_{t+1}
        da_t = g_t h_{t-1} + g_t i_t x_t · d sqrt(max(1 - a_t², 1e-12)) / da_t
        dx_t = g_t b_t' i_t,   di_t = g_t b_t' x_t   (b_t' = sqrt(max(1 - a_t², 1e-12)))
        dr_t = da_t · a_t · (-8 softplus(-λ))
        dλ   = 8 sigmoid(-λ) Σ_{b,t} da_t a_t r_t

    The square root's derivative is 0 where the clamp holds (1 - a² at or
    below 1e-12), as JAX's ``maximum`` gives it away from a tie."""
    wd = work_dtype(x.dtype)
    B, S, W = x.shape
    xf, rf, i_f, dyf, lamf = (t.to(wd) for t in (x, r, i, dy, lam))
    sp = softplus(-lamf)
    a = torch.exp(-C_FACTOR * rf * sp)
    m = 1.0 - a * a
    gain = torch.sqrt(torch.clamp(m, min=1e-12))
    ix = i_f * xf
    hprev = torch.empty_like(xf)  # h_{t-1}
    h = torch.zeros((B, W), dtype=wd, device=x.device)
    for t in range(S):
        hprev[:, t] = h
        h = a[:, t] * h + gain[:, t] * ix[:, t]
    g = torch.empty_like(xf)
    carry = torch.zeros((B, W), dtype=wd, device=x.device)  # a_{t+1} g_{t+1}
    for t in reversed(range(S)):
        g[:, t] = dyf[:, t] + carry
        carry = a[:, t] * g[:, t]
    dgain = torch.where(m > 1e-12, -a / gain, torch.zeros((), dtype=wd, device=x.device))
    da = g * hprev + g * ix * dgain
    dlam = C_FACTOR * torch.sigmoid(-lamf) * (da * a * rf).sum((0, 1))
    return ((g * gain * i_f).to(x.dtype), (da * a * (-C_FACTOR * sp)).to(r.dtype),
            (g * gain * xf).to(i.dtype), dlam.to(lam.dtype))


def make_inputs(
    generator: Optional[torch.Generator] = None, B=1, S=2048, W=2560,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(x, r, i, lam) as the JAX ``make_inputs`` draws them: standard-normal
    x, sigmoid gates, and Λ = logit(u) for u uniform in (0.9, 0.999)."""

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32, device=device)

    x = normal(B, S, W)
    r = torch.sigmoid(normal(B, S, W))
    i = torch.sigmoid(normal(B, S, W))
    u = 0.9 + 0.099 * torch.rand((W,), generator=generator, dtype=torch.float32,
                                 device=device)
    lam = torch.log(u / (1 - u))
    return x, r, i, lam
