"""GQA attention: the kernel route, full, local-window, decode, cross.

The port of ``repro.models.attention``.  The JAX models compute causal
self-attention in XLA: ``blocked_causal_attention`` and its custom-VJP
twin ``flash_attention_xla`` (which "double as the reference semantics for
the Pallas kernel") or ``full_attention(causal=True)``.  On the card the
port's hand-written flash kernel takes their place: :func:`causal_attention`
sends CUDA tensors to ``autotuned("flash_attention")`` and CPU tensors to
:func:`full_attention`, the plain version (:mod:`.route`).  So
``blocked_causal_attention`` and ``flash_attention_xla`` are not ported.
Where autograd wants a gradient of a call on CUDA tensors, it runs
:class:`FlashAttentionFn`, the counterpart of ``flash_attention_xla``'s
custom VJP: the forward kernel with its ``lse`` residual, and the
backward kernel (``autotuned("flash_attention_bwd")``) in place of
``_flash_bwd``; on CPU tensors autograd runs through the plain version.

What has no kernel stays in torch ops, as the JAX package uses XLA there:
non-causal attention (the Whisper encoder; the flash op of the registry is
causal only), cross attention, local-window attention and decode attention
(one query).  Each repeats its JAX counterpart's dtypes: scores are
formed in the inputs' dtype, then taken to fp32, the softmax weights cast
back to the query's dtype.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import flash_attention as fa_mod
from .config import ModelConfig
from .layers import dot, mrope_apply, promote, rope_apply
from .route import in_this_context, kernel_state, needs_grad, on_kernel, run_kernel
from .spec import ParamSpec

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------


def attn_spec(cfg: ModelConfig, cross: bool = False) -> Dict[str, ParamSpec]:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    spec: Dict[str, ParamSpec] = {
        "wq": ParamSpec((d, h, hd), ("embed", "q_heads", "head_dim")),
        "wk": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((h, hd, d), ("q_heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias and not cross:
        spec["bq"] = ParamSpec((h, hd), ("q_heads", "head_dim"), init="zeros")
        spec["bk"] = ParamSpec((kv, hd), ("kv_heads", "head_dim"), init="zeros")
        spec["bv"] = ParamSpec((kv, hd), ("kv_heads", "head_dim"), init="zeros")
    if cfg.qk_norm and not cross:
        spec["q_norm"] = ParamSpec((hd,), ("head_dim",), init="ones")
        spec["k_norm"] = ParamSpec((hd,), ("head_dim",), init="ones")
    return spec


# ---------------------------------------------------------------------------
# Projections
# ---------------------------------------------------------------------------


def project_qkv(
    x: torch.Tensor, p, cfg: ModelConfig, positions: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> q (B,S,H,hd), k/v (B,S,KV,hd), with bias/qk_norm/RoPE."""
    q = dot(x, p["wq"])
    k = dot(x, p["wk"])
    v = dot(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if "q_norm" in p:
        q = _headwise_rms(q, p["q_norm"], cfg.norm_eps)
        k = _headwise_rms(k, p["k_norm"], cfg.norm_eps)
    if positions is not None:
        if cfg.mrope:
            q = mrope_apply(q, positions, cfg.rope_theta, cfg.mrope_sections)
            k = mrope_apply(k, positions, cfg.rope_theta, cfg.mrope_sections)
        else:
            q = rope_apply(q, positions, cfg.rope_theta)
            k = rope_apply(k, positions, cfg.rope_theta)
    return q, k, v


def _headwise_rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def output_proj(o: torch.Tensor, p) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd", o, wo)``."""
    return dot(o.flatten(-2), p["wo"].flatten(0, 1))


# ---------------------------------------------------------------------------
# Attention cores
# ---------------------------------------------------------------------------


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal self-attention with ``Sq == Sk``: the flash kernel (tuned
    and recalled through the registry, :func:`.route.run_kernel`) on CUDA
    tensors, through :class:`FlashAttentionFn` where a gradient is wanted;
    the plain :func:`full_attention` on CPU tensors."""
    if on_kernel(q):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if needs_grad(q, k, v):
            return FlashAttentionFn.apply(q, k, v, kernel_forward,
                                          in_this_context(kernel_backward))
        return run_kernel("flash_attention", q, k, v)
    fa_mod.counter.ran_plain()
    return full_attention(q, k, v, causal=True)


def kernel_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """(o, lse) from the forward kernel at the point its shape class tuned
    (or recalled): the class serving uses, so training pays no second tune."""
    point = kernel_state("flash_attention", q, k, v).region.selected
    return fa_mod.flash_attention(q, k, v, **point, return_lse=True)


def kernel_backward(q, k, v, o, lse, do):
    """(dq, dk, dv) from the backward kernel, tuned per shape class."""
    return run_kernel("flash_attention_bwd", q, k, v, o, lse, do)


class FlashAttentionFn(torch.autograd.Function):
    """Causal GQA attention whose backward recomputes the scores block by
    block from what the forward saves, ``(q, k, v, o, lse)``, O(S·d) as
    the JAX ``_flash_fwd`` residuals are.  ``forward_fn(q, k, v)`` returns
    ``(o, lse)`` and ``backward_fn(q, k, v, o, lse, do)`` returns ``(dq,
    dk, dv)``: the kernels (:func:`kernel_forward`,
    :func:`kernel_backward`), or their plain versions
    (``attention_ref(..., return_lse=True)``, ``attention_bwd_plain``)."""

    @staticmethod
    def forward(ctx, q, k, v, forward_fn, backward_fn):
        o, lse = forward_fn(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.backward_fn = backward_fn
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = ctx.backward_fn(q, k, v, o, lse, do.contiguous())
        return dq, dk, dv, None, None


def full_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, q_offset: int = 0,
) -> torch.Tensor:
    """Materialized-scores attention (small seq / encoder / oracle)."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg, kk = promote(q.reshape(B, Sq, KV, G, hd), k)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, kk).float()
    scores = scores / math.sqrt(hd)
    if causal:
        Sk = k.shape[1]
        qpos = torch.arange(Sq, device=q.device) + q_offset
        kpos = torch.arange(Sk, device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        scores = scores.masked_fill(~mask, NEG_INF)
    w, vv = promote(torch.softmax(scores, dim=-1).to(q.dtype), v)
    o = torch.einsum("bkgqs,bskd->bqkgd", w, vv)
    return o.reshape(B, Sq, H, hd)


def local_window_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int, block_q: int,
) -> torch.Tensor:
    """Sliding-window causal attention (RecurrentGemma's attention blocks):
    each q block attends to the ``window`` positions preceding it
    (inclusive of self), from front-padded K/V, as the JAX version does."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    bq = min(block_q, S)
    if S % bq:
        raise ValueError(f"seq {S} must divide block_q {bq}")
    nq = S // bq
    scale = 1.0 / math.sqrt(hd)
    W = window

    kp = F.pad(k, (0, 0, 0, 0, W, 0))
    vp = F.pad(v, (0, 0, 0, 0, W, 0))
    qb = q.reshape(B, nq, bq, KV, G, hd)
    iq = torch.arange(bq, device=q.device)[:, None]
    ik = torch.arange(W + bq, device=q.device)[None, :]
    outs = []
    for qi in range(nq):
        # visible kv span: [qi*bq - W, qi*bq + bq) in unpadded coords
        start = qi * bq
        k_blk, v_blk = kp[:, start:start + W + bq], vp[:, start:start + W + bq]
        qq, kk = promote(qb[:, qi], k_blk)
        s = torch.einsum("bqkgd,bskd->bkgqs", qq, kk).float()
        s = s * scale
        mask = (ik - W <= iq) & (iq - (ik - W) < W) & (ik + (qi * bq - W) >= 0)
        s = s.masked_fill(~mask, NEG_INF)
        w, vv = promote(torch.softmax(s, dim=-1).to(q.dtype), v_blk)
        outs.append(torch.einsum("bkgqs,bskd->bqkgd", w, vv))  # (B, bq, KV, G, hd)
    return torch.stack(outs, dim=1).reshape(B, S, H, hd)


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, hd)
    k_cache: torch.Tensor,  # (B, L, KV, hd)
    v_cache: torch.Tensor,
    cache_len,  # valid prefix length: an int, or a (B,) tensor, one a row
    window: Optional[int] = None,
) -> torch.Tensor:
    B, _, H, hd = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    L = k_cache.shape[1]
    qg, kk = promote(q.reshape(B, KV, G, hd), k_cache)
    s = torch.einsum("bkgd,bskd->bkgs", qg, kk).float()
    s = s / math.sqrt(hd)
    pos = torch.arange(L, device=q.device)
    if isinstance(cache_len, torch.Tensor):  # per row, against s's (B, KV, G, L)
        cache_len = cache_len.reshape(B, 1, 1, 1)
    valid = pos < cache_len
    if window is not None:
        valid = valid & (pos >= cache_len - window)
    s = s.masked_fill(~valid, NEG_INF)
    w, vv = promote(torch.softmax(s, dim=-1).to(q.dtype), v_cache)
    o = torch.einsum("bkgs,bskd->bkgd", w, vv)
    return o.reshape(B, 1, H, hd)


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return full_attention(q, k, v, causal=False)
