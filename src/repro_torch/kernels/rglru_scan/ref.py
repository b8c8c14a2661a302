"""Plain PyTorch version of the RG-LRU scan kernel (post-gate quantities).

It repeats the JAX package's ``rglru_scan_ref`` op for op, one time step
after another:

    a_t = exp(-8 · r_t · softplus(-λ))
    h_t = a_t · h_{t-1} + sqrt(max(1 - a_t², 1e-12)) · (i_t · x_t)
    y_t = h_t

``softplus`` is ``logaddexp(x, 0)``, as ``jax.nn.softplus`` computes it:
``torch.nn.functional.softplus`` returns x itself above its threshold.
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
    softplus_neg_lam = softplus(-lam.float())
    B, S, W = x.shape
    h = torch.zeros((B, W), dtype=torch.float32, device=x.device)
    ys = torch.empty((B, S, W), dtype=torch.float32, device=x.device)
    xf, rf, i_f = x.float(), r.float(), i.float()
    for t in range(S):
        a = torch.exp(-C_FACTOR * rf[:, t] * softplus_neg_lam)
        h = a * h + torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i_f[:, t] * xf[:, t])
        ys[:, t] = h
    return ys.to(x.dtype)


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
