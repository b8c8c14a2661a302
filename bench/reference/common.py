"""Shared pieces of the references: float32 set-up, norms, activations,
rotary embedding, and the matrix products and stored activations of the
two precisions."""
from __future__ import annotations

import torch


def full_float32() -> None:
    """Float32 products in float32: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (B, S, heads, hd) at positions 0..S-1, the
    head dim split in halves: (x1, x2) -> (x1 cos - x2 sin, x2 cos + x1 sin)."""
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def F32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.matmul`` in float32."""
    return torch.matmul(a, b)


def _fp8(x: torch.Tensor, fmt) -> torch.Tensor:
    """``x`` rounded to the 8-bit float ``fmt`` under one per-tensor scale
    (its largest magnitude at the format's largest value), back in x's dtype."""
    fmax = torch.finfo(fmt).max
    scale = x.detach().abs().amax().clamp_min(1e-30) / fmax
    return (x / scale).to(fmt).to(x.dtype) * scale


class _Fp8Matmul(torch.autograd.Function):
    """A product as 8-bit float training runs it: both inputs rounded to
    e4m3 forward, the incoming gradient to e5m2 backward, each product
    accumulated in float32."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _fp8(a, torch.float8_e4m3fn), _fp8(b, torch.float8_e4m3fn)
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _fp8(g, torch.float8_e5m2)
        ga = torch.matmul(qg, qb.transpose(-1, -2))
        gb = torch.matmul(qa.transpose(-1, -2), qg)
        # sum the broadcast batch dims back to each input's shape
        while ga.dim() > qa.dim():
            ga = ga.sum(0)
        while gb.dim() > qb.dim():
            gb = gb.sum(0)
        for i, (n, m) in enumerate(zip(ga.shape, qa.shape)):
            if m == 1 and n != 1:
                ga = ga.sum(i, keepdim=True)
        for i, (n, m) in enumerate(zip(gb.shape, qb.shape)):
            if m == 1 and n != 1:
                gb = gb.sum(i, keepdim=True)
        return ga, gb


def kept(x: torch.Tensor) -> torch.Tensor:
    """An activation stored as the float32 reference stores it: unchanged."""
    return x


def fp8_kept(x: torch.Tensor) -> torch.Tensor:
    """An activation stored as the serving control stores it: e4m3 under a
    per-tensor scale (where the configuration stores bfloat16)."""
    return _fp8(x, torch.float8_e4m3fn)


def FP8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The control's product: 8-bit float inputs (e4m3), 8-bit float
    gradients (e5m2), float32 accumulation."""
    return _Fp8Matmul.apply(a, b)
