"""Plain PyTorch versions of the flash attention kernels: materialized causal
GQA attention, as the JAX package's ``attention_ref`` computes it, with its
``lse`` residual, and the backward pass (:func:`attention_bwd_plain`, the
port of the JAX ``_flash_bwd``).

Scores are taken in float32 from the inputs upcast (a product of two bf16
values is exact in float32), as both kernels take them; the JAX oracle
rounds bf16 scores to bf16 first, which the bf16 tolerance covers.  The
softmax weights are rounded to the input type before the weighted sum, and
the sum is rounded to the input type.
On the card it needs ``torch.backends.cuda.matmul.allow_tf32 = False``
(PyTorch's default) to stay in full float32.  Both work in float32, or in
float64 for float64 inputs (``torch.autograd.gradcheck``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def attention_ref(
    q: torch.Tensor,  # (B, S, H, hd)
    k: torch.Tensor,  # (B, S, KV, hd)
    v: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
    return_lse: bool = False,
):
    """``scale`` defaults to 1/sqrt(hd); the CUDA wrapper runs a padded hd
    at the scale of the true one.  With ``return_lse`` also the softmax's
    log-sum-exp of the scaled scores, float32 (B, H, S), query head
    h = kv·G + g: the JAX ``_flash_forward_blocks`` residual ``m + log l``
    (B, KV, G, S) flattened."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    wd = work_dtype(q.dtype)
    qg = q.reshape(B, S, KV, G, hd).to(wd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(wd))
    s = s / math.sqrt(hd) if scale is None else s * scale
    if causal:
        pos = torch.arange(S, device=q.device)
        mask = pos[:, None] >= pos[None, :]
        s = s.masked_fill(~mask, NEG_INF)
    w = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", w.to(wd), v.to(wd)).to(q.dtype)
    o = o.reshape(B, S, H, hd)
    if not return_lse:
        return o
    lse = torch.logsumexp(s, dim=-1).reshape(B, H, S)
    return o, lse


def work_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type the plain versions compute in: float32, or float64 for
    float64 inputs."""
    return torch.promote_types(dtype, torch.float32)


def attention_bwd_plain(
    q: torch.Tensor,  # (B, S, H, hd)
    k: torch.Tensor,  # (B, S, KV, hd)
    v: torch.Tensor,
    o: torch.Tensor,  # (B, S, H, hd), the forward's output
    lse: torch.Tensor,  # (B, H, S) float32, the forward's residual
    do: torch.Tensor,  # (B, S, H, hd), the output's gradient
    scale: Optional[float] = None,
):
    """(dq, dk, dv) of causal GQA attention: the port of the JAX
    ``_flash_bwd`` (``src/repro/models/attention.py:260``) with the blocks
    taken whole.  P = exp(S·scale − lse) below the diagonal, delta =
    rowsum(do ⊙ o), dS = P ⊙ (dP − delta)·scale; dq = dS·K, dk = dSᵀ·Q,
    dv = Pᵀ·dO, each summed over the G query heads of a KV head.  As the
    JAX function does in the inputs' type: S and dP are rounded to it (its
    einsums' outputs), P before Pᵀ·dO and dS before the two products that
    take it; every sum runs in the work type, each gradient rounded to its
    input's type once."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    wd = work_dtype(q.dtype)
    scale = 1.0 / math.sqrt(hd) if scale is None else scale

    def rnd(x):  # a value rounded to the inputs' type, kept in the work type
        return x.to(q.dtype).to(wd)

    qg = q.reshape(B, S, KV, G, hd).to(wd)
    dog = do.reshape(B, S, KV, G, hd).to(wd)
    kk, vv = k.to(wd), v.to(wd)
    delta = (do.to(wd) * o.to(wd)).sum(-1).reshape(B, S, KV, G).permute(0, 2, 3, 1)
    lse_g = lse.to(wd).reshape(B, KV, G, S)
    s = rnd(torch.einsum("bqkgd,bskd->bkgqs", qg, kk)) * scale
    pos = torch.arange(S, device=q.device)
    mask = pos[:, None] >= pos[None, :]
    p = torch.where(mask, torch.exp(s - lse_g[..., None]), torch.zeros((), dtype=wd,
                                                                         device=q.device))
    dp = rnd(torch.einsum("bqkgd,bskd->bkgqs", dog, vv))
    ds = p * (dp - delta[..., None]) * scale
    dv = torch.einsum("bkgqs,bqkgd->bskd", rnd(p), dog)
    dk = torch.einsum("bkgqs,bqkgd->bskd", rnd(ds), qg)
    dq = torch.einsum("bkgqs,bskd->bqkgd", rnd(ds), kk).reshape(B, S, H, hd)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def make_inputs(
    generator=None, B=1, S=2048, H=32, KV=4, hd=64, dtype=torch.bfloat16,
    device="cuda",
):
    """Standard-normal (q, k, v) in (B, S, heads, hd) from ``generator``."""

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=device).to(dtype)

    return normal(B, S, H, hd), normal(B, S, KV, hd), normal(B, S, KV, hd)
