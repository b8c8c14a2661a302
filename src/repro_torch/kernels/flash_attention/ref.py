"""Plain PyTorch version of the flash attention kernel: materialized causal
GQA attention, as the JAX package's ``attention_ref`` computes it.

Scores are taken in float32 from the inputs upcast (a product of two bf16
values is exact in float32), as both kernels take them; the JAX oracle
rounds bf16 scores to bf16 first, which the bf16 tolerance covers.  The
softmax weights are rounded to the input type before the weighted sum, and
the sum is rounded to the input type.
On the card it needs ``torch.backends.cuda.matmul.allow_tf32 = False``
(PyTorch's default) to stay in full float32.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def attention_ref(
    q: torch.Tensor,  # (B, S, H, hd)
    k: torch.Tensor,  # (B, S, KV, hd)
    v: torch.Tensor,
    causal: bool = True,
) -> torch.Tensor:
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) / math.sqrt(hd)
    if causal:
        pos = torch.arange(S, device=q.device)
        mask = pos[:, None] >= pos[None, :]
        s = s.masked_fill(~mask, NEG_INF)
    w = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", w.float(), v.float()).to(q.dtype)
    return o.reshape(B, S, H, hd)


def make_inputs(
    generator=None, B=1, S=2048, H=32, KV=4, hd=64, dtype=torch.bfloat16,
    device="cuda",
):
    """Standard-normal (q, k, v) in (B, S, heads, hd) from ``generator``."""

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=device).to(dtype)

    return normal(B, S, H, hd), normal(B, S, KV, hd), normal(B, S, KV, hd)
