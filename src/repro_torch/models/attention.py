"""GQA attention: the kernel route, full, local-window, decode, cross.

The port of ``repro.models.attention``.  The JAX models compute causal
self-attention in XLA: ``blocked_causal_attention`` and its custom-VJP
twin ``flash_attention_xla`` (which "double as the reference semantics for
the Pallas kernel") or ``full_attention(causal=True)``.  On the card the
port's hand-written flash kernel takes their place: :func:`causal_attention`
sends CUDA tensors to ``autotuned("flash_attention")`` and CPU tensors to
:func:`full_attention`, the plain version (:mod:`.route`).  So
``blocked_causal_attention`` and ``flash_attention_xla`` are not ported;
their backward pass waits for training.

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

from ..core import autotuned
from ..kernels.flash_attention import flash_attention as fa_mod
from .config import ModelConfig
from .layers import dot, mrope_apply, promote, rope_apply
from .route import on_kernel
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
    and recalled through the registry) on CUDA tensors, the plain
    :func:`full_attention` on CPU tensors."""
    if on_kernel(q):
        return autotuned("flash_attention")(q.contiguous(), k.contiguous(), v.contiguous())
    fa_mod.counter.plain_calls += 1
    return full_attention(q, k, v, causal=True)


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
    cache_len: int,  # valid prefix length
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
    valid = pos < cache_len
    if window is not None:
        valid = valid & (pos >= cache_len - window)
    s = s.masked_fill(~valid, NEG_INF)
    w, vv = promote(torch.softmax(s, dim=-1).to(q.dtype), v_cache)
    o = torch.einsum("bkgs,bskd->bkgd", w, vv)
    return o.reshape(B, 1, H, hd)


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return full_attention(q, k, v, causal=False)
