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

Under the dry-run (fake tensors in DTensors, :func:`.route.on_stand_in`)
causal attention runs the flash kernels' shape-only stand-ins on each
device's shards, and decode attention runs on the shards of the cache as
its rule places them.  Where the rule shards the cache length
(``kv_slots``, flash decoding) each device forms the softmax's partials
over its own slots, its local max, sum and weighted values, and two
all-reduces (max, then sum) combine them (:func:`combine_partials`), as
XLA's partitioner does for a softmax over a sharded axis; nothing gathers
the cache.  A query head sharded where the cache's KV heads are not
reads only the KV heads its own heads use, sliced from the local cache.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import flash_attention as fa_mod
from .config import ModelConfig
from .layers import dot, mrope_apply, promote, rope_apply
from .route import (
    flash_bwd_stand_in, flash_stand_in, in_this_context, kernel_state, needs_grad, on_kernel,
    on_stand_in, run_kernel, run_on_shards,
)
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
    the plain :func:`full_attention` on CPU tensors; the stand-ins on fake
    ones."""
    if on_stand_in(q):
        return _stand_in_attention(q, k, v)
    if on_kernel(q):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if needs_grad(q, k, v):
            return FlashAttentionFn.apply(q, k, v, kernel_forward,
                                          in_this_context(kernel_backward))
        return run_kernel("flash_attention", q, k, v)
    fa_mod.counter.ran_plain()
    return full_attention(q, k, v, causal=True)


def _stand_in_attention(q, k, v):
    """The dry-run's causal attention: the flash kernels' stand-ins through
    :class:`FlashAttentionFn` (saving what the kernel route saves), on each
    device's shards of DTensor operands (:func:`_head_placements`)."""

    def local(q, k, v):
        if needs_grad(q, k, v):
            return FlashAttentionFn.apply(q, k, v, flash_stand_in,
                                          in_this_context(flash_bwd_stand_in))
        return flash_stand_in(q, k, v)[0]

    if not hasattr(q, "device_mesh"):
        return local(q, k, v)
    return on_head_shards(local, q, k, v)


def on_head_shards(fn, q, k, v):
    """``fn(q, k, v)``, an attention over whole sequences, on each device's
    shards of DTensor operands (:func:`_head_placements`): the output
    placed as q's shards are."""
    q_pl, kv_pl, kv_grad, kv_slice = _head_placements(q, k)
    local = fn if kv_slice is None else (
        lambda q, k, v: fn(q, k[:, :, kv_slice], v[:, :, kv_slice]))
    return run_on_shards(local, (q, k, v), (q_pl, kv_pl, kv_pl), q_pl,
                         grad_placements=(None, kv_grad, kv_grad))


def _head_placements(q, k, slots_dim: Optional[int] = None):
    """Where attention's operands keep their shards, per mesh axis, for q
    (B, Sq, H, hd) against k and v (B, Sk or slots, KV, hd): the batch stays
    sharded; the heads stay sharded where both are; where only q's heads
    are (KV heads too few for the axis), q keeps them and each device
    reads the KV heads its own heads use, sliced from its replica of k, v
    (their gradient is then a partial sum); the cache's slots
    (``slots_dim``) stay sharded, q gathered there.  Anything else is
    gathered.  Returns (q placements, k/v placements, k/v gradient
    placements or None, the KV-head slice or None)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = q.device_mesh
    H, KV = q.shape[2], k.shape[2]
    G = H // KV
    q_pl, kv_pl = [], []
    kv_slice = slice_axis = None
    for axis, (pq, pk) in enumerate(zip(q.placements, k.placements)):
        hl = H // mesh.size(axis)
        if isinstance(pk, Shard) and pk.dim in (0, 2):
            q_pl.append(Shard(pk.dim))
            kv_pl.append(Shard(pk.dim))
        elif slots_dim is not None and isinstance(pk, Shard) and pk.dim == slots_dim:
            q_pl.append(Replicate())
            kv_pl.append(Shard(slots_dim))
        elif (isinstance(pq, Shard) and pq.dim == 2 and slice_axis is None
              and (hl % G == 0 or G % hl == 0)):
            q_pl.append(Shard(2))
            kv_pl.append(Replicate())
            r = mesh.get_local_rank(axis)
            kv_slice, slice_axis = slice(r * hl // G, ((r + 1) * hl - 1) // G + 1), axis
        else:
            q_pl.append(Replicate())
            kv_pl.append(Replicate())
    grad_pl = None
    if slice_axis is not None:
        grad_pl = tuple(Partial() if a == slice_axis else p for a, p in enumerate(kv_pl))
    return tuple(q_pl), tuple(kv_pl), grad_pl, kv_slice


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
    """Materialized-scores attention (small seq / encoder / oracle); on
    DTensors, on each device's shards (:func:`on_head_shards`)."""
    if hasattr(q, "device_mesh"):
        return on_head_shards(lambda q, k, v: full_attention(q, k, v, causal, q_offset), q, k, v)
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
    (inclusive of self), from front-padded K/V, as the JAX version does;
    on DTensors, on each device's shards (:func:`on_head_shards`)."""
    if hasattr(q, "device_mesh"):
        return on_head_shards(
            lambda q, k, v: local_window_attention(q, k, v, window, block_q), q, k, v)
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
    if hasattr(k_cache, "device_mesh"):  # a DTensor (the dry-run)
        return _decode_on_shards(q, k_cache, v_cache, cache_len, window)
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


def decode_partials(q, k_part, v_part, cache_len: int, offset: int,
                    window: Optional[int] = None):
    """One part of the cache's slots, ``offset`` onwards, against q: the
    softmax's partials (local max m, sum l of exp(s - m), and the values
    weighted by exp(s - m), float32), for :func:`combine_partials`."""
    B, _, H, hd = q.shape
    KV = k_part.shape[2]
    qg, kk = promote(q.reshape(B, KV, q.shape[2] // KV, hd), k_part)
    s = torch.einsum("bkgd,bskd->bkgs", qg, kk).float() / math.sqrt(hd)
    pos = torch.arange(k_part.shape[1], device=q.device) + offset
    valid = pos < cache_len
    if window is not None:
        valid = valid & (pos >= cache_len - window)
    s = s.masked_fill(~valid, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    w, vv = promote(p.to(q.dtype), v_part)
    o = torch.einsum("bkgs,bskd->bkgd", w, vv).float()
    return m, p.sum(dim=-1, keepdim=True), o


def combine_partials(m, l, o, all_max, all_sum, dtype) -> torch.Tensor:
    """Flash decoding's combine of every part's partials: the global max
    (``all_max``), each part's sum and values rescaled to it and summed
    (``all_sum``), the values over the sum, as (B, KV, G, hd) in
    ``dtype``.  ``all_max``/``all_sum`` reduce over the parts: all-reduces
    across devices, or a reduction over a stacked leading axis."""
    g = all_max(m)
    scale = torch.exp(m - g)
    l = all_sum(l * scale)
    o = all_sum(o * scale)
    return (o / l).to(dtype)


def _decode_on_shards(q, k_cache, v_cache, cache_len, window):
    """Decode attention on each device's shards of a DTensor cache
    (:func:`_head_placements`).  Where the cache's slots are sharded, each
    device takes its own slots' partials and an all-reduce max, then an
    all-reduce sum over those mesh axes combine them."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Shard

    if isinstance(cache_len, torch.Tensor):
        raise NotImplementedError("per-row cache lengths on a sharded cache")
    mesh = k_cache.device_mesh
    q_pl, kv_pl, _, kv_slice = _head_placements(q, k_cache, slots_dim=1)
    slot_axes = [a for a, p in enumerate(kv_pl) if isinstance(p, Shard) and p.dim == 1]

    def local(q, kc, vc):
        if kv_slice is not None:
            kc, vc = kc[:, :, kv_slice], vc[:, :, kv_slice]
        if not slot_axes:
            return decode_attention(q, kc, vc, cache_len, window)
        part = 0
        for a in slot_axes:  # this device's part of the slots, mesh order
            part = part * mesh.size(a) + mesh.get_local_rank(a)
        m, l, o = decode_partials(q, kc, vc, cache_len, part * kc.shape[1], window)
        groups = [(mesh, a) for a in slot_axes]

        def reduce(op):
            def run(t):
                for g in groups:
                    t = funcol.wait_tensor(funcol.all_reduce(t, op, g))
                return t
            return run

        out = combine_partials(m, l, o, reduce("max"), reduce("sum"), q.dtype)
        return out.reshape(q.shape)

    return run_on_shards(local, (q, k_cache, v_cache), (q_pl, kv_pl, kv_pl), q_pl)


def write_slot_on_shards(c, rows, slot, val: torch.Tensor) -> None:
    """``c[:, slot] = val`` on each device's shard of a DTensor cache
    (B, slots, KV, hd), in place: the device that holds slot ``slot``
    writes it, from its own shard of ``val`` (B, KV, hd); nothing moves
    the cache."""
    from torch.distributed.tensor import Replicate, Shard

    if rows is not None:
        raise NotImplementedError("per-row slots on a sharded cache")
    mesh = c.device_mesh
    val_pl = []
    part, local = 0, c.to_local()
    for a, p in enumerate(c.placements):
        if isinstance(p, Shard) and p.dim == 1:
            part = part * mesh.size(a) + mesh.get_local_rank(a)
            val_pl.append(Replicate())
        elif isinstance(p, Shard):
            val_pl.append(Shard(p.dim - (p.dim > 1)))
        else:
            val_pl.append(Replicate())
    n = local.shape[1]
    v = val.to(c.dtype)
    v = v.redistribute(mesh, val_pl).to_local() if hasattr(v, "redistribute") else v
    if part * n <= slot < (part + 1) * n:
        local[:, slot - part * n] = v


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return full_attention(q, k, v, causal=False)
