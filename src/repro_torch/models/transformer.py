"""Decoder-only LM assembly for dense / MoE / SSM / hybrid / VLM families.

The port of ``repro.models.transformer``, with three entry points per
family: full-sequence :func:`forward`, :func:`prefill` (returns the decode
cache) and :func:`decode_step` (one token).  Where the JAX package scans
over a stacked ``layers`` axis (and, for the hybrid family, over
period-groups of its block pattern plus a tail), the port loops over a
``ModuleList`` of layers in order; layer i of a hybrid model is of kind
``block_pattern[i % period]``.  Left out, as training's or XLA's: remat
(``_maybe_checkpoint``), ``scan_layers`` and sharding constraints (one
card).

The decode cache keeps the JAX package's layout, key for key: stacked
(layers, B, capacity, KV, hd) bf16 K/V and an int ``len`` for the
attention families; stacked conv windows (bf16) and float32 states for
the SSM; per block-pattern slot ``b{idx}_*`` stacked over groups and
per tail layer ``t{t}_*`` for the hybrid, whose attention caches are a
ring of ``min(local_window, capacity)`` slots written at ``pos mod W``.
:func:`decode_step` writes the new token's entries into the cache's
tensors in place and returns the cache with ``len`` advanced.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .attention import (
    attn_spec, causal_attention, decode_attention, local_window_attention, output_proj,
    project_qkv,
)
from .config import ModelConfig
from .layers import (
    embed, embed_spec, rmsnorm, rmsnorm_spec, swiglu, swiglu_spec, unembed, unembed_spec,
)
from .moe import moe_block, moe_spec
from .rglru import rglru_block, rglru_block_with_state, rglru_decode_step, rglru_init_cache, rglru_spec
from .spec import ParamSpec
from .ssm import ssm_block, ssm_block_with_state, ssm_decode_step, ssm_init_cache, ssm_spec


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------


def decoder_specs(cfg: ModelConfig) -> Dict[str, Any]:
    specs: Dict[str, Any] = {
        "embed": embed_spec(cfg),
        "final_norm": rmsnorm_spec(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = unembed_spec(cfg)
    d = cfg.d_model
    if cfg.family in ("dense", "vlm", "moe"):
        mix = "moe" if cfg.family == "moe" else "mlp"
        specs["layers"] = [
            {
                "ln1": ParamSpec((d,), ("embed",), init="ones"),
                "attn": attn_spec(cfg),
                "ln2": ParamSpec((d,), ("embed",), init="ones"),
                mix: moe_spec(cfg) if mix == "moe" else swiglu_spec(d, cfg.d_ff),
            }
            for _ in range(cfg.n_layers)
        ]
    elif cfg.family == "ssm":
        specs["layers"] = [
            {"ln": ParamSpec((d,), ("embed",), init="ones"), "ssm": ssm_spec(cfg)}
            for _ in range(cfg.n_layers)
        ]
    elif cfg.family == "hybrid":
        specs["layers"] = [_hybrid_block_spec(cfg, hybrid_kind(cfg, i))
                           for i in range(cfg.n_layers)]
    else:
        raise ValueError(f"decoder_specs: unsupported family {cfg.family}")
    return specs


def hybrid_kind(cfg: ModelConfig, i: int) -> str:
    """The block kind of hybrid layer ``i`` (groups, then the tail, both
    walk the block pattern from its start)."""
    return cfg.block_pattern[i % len(cfg.block_pattern)]


def hybrid_slot(cfg: ModelConfig, i: int) -> Tuple[str, Optional[int]]:
    """Where hybrid layer ``i`` sits in the JAX package's layout: its
    pattern slot ``b{idx}`` and group, or its tail slot ``t{t}`` (no
    group)."""
    period = len(cfg.block_pattern)
    n_groups = cfg.n_layers // period
    if i < n_groups * period:
        g, idx = divmod(i, period)
        return f"b{idx}", g
    return f"t{i - n_groups * period}", None


def _hybrid_block_spec(cfg: ModelConfig, kind: str) -> Dict[str, Any]:
    base = {
        "ln1": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        "ln2": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        "mlp": swiglu_spec(cfg.d_model, cfg.d_ff),
    }
    if kind == "rec":
        base["rec"] = rglru_spec(cfg)
    elif kind == "attn":
        base["attn"] = attn_spec(cfg)
    else:
        raise ValueError(f"unknown hybrid block kind {kind!r}")
    return base


# ---------------------------------------------------------------------------
# Layer applications
# ---------------------------------------------------------------------------


def attention_mix(x, p, cfg: ModelConfig, positions, window: Optional[int] = None):
    """Pre-norm attention with residual.  Returns (x, (k, v)) for caching.

    The JAX choice of core, quirks included: a hybrid layer takes the
    local window only when S exceeds the window and ``attn_block_q`` tiles
    S, else full causal attention; every causal self-attention with
    ``Sq == Sk`` (the JAX package's ``flash_attention_xla`` past 2048
    tokens, ``full_attention`` below) is :func:`causal_attention`."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    q, k, v = project_qkv(h, p["attn"], cfg, positions)
    S = x.shape[1]
    if window is not None and S % min(cfg.attn_block_q, S) == 0 and S > window:
        o = local_window_attention(q, k, v, window, cfg.attn_block_q)
    else:
        o = causal_attention(q, k, v)
    x = x + output_proj(o, p["attn"])
    return x, (k, v)


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _dense_layer(x, p, cfg: ModelConfig, positions):
    x, kv = attention_mix(x, p, cfg, positions)
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + swiglu(h, p["mlp"]), kv, _zero(x)


def _moe_layer(x, p, cfg: ModelConfig, positions):
    x, kv = attention_mix(x, p, cfg, positions)
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    delta, aux = moe_block(h, p["moe"], cfg)
    return x + delta, kv, aux


def _ssm_layer(x, p, cfg: ModelConfig, positions):
    h = rmsnorm(x, p["ln"], cfg.norm_eps)
    return x + ssm_block(h, p["ssm"], cfg), None, _zero(x)


def _hybrid_layer(x, p, cfg: ModelConfig, positions, kind: str):
    if kind == "rec":
        h = rmsnorm(x, p["ln1"], cfg.norm_eps)
        x = x + rglru_block(h, p["rec"], cfg)
        kv = None
    else:
        x, kv = attention_mix(x, p, cfg, positions, window=cfg.local_window)
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + swiglu(h, p["mlp"]), kv, _zero(x)


_LAYER_FN = {"dense": _dense_layer, "vlm": _dense_layer, "moe": _moe_layer,
             "ssm": _ssm_layer}


# ---------------------------------------------------------------------------
# Full-sequence forward — logits over all positions
# ---------------------------------------------------------------------------


def forward(
    params, tokens: torch.Tensor, cfg: ModelConfig,
    positions: Optional[torch.Tensor] = None,
    vision_embeds: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B,S,V) fp32, aux_loss scalar)."""
    x, positions = _embed_inputs(params, tokens, cfg, positions, vision_embeds)
    aux = _zero(x)
    for i, lp in enumerate(params["layers"]):
        if cfg.family == "hybrid":
            x, _, a = _hybrid_layer(x, lp, cfg, positions, hybrid_kind(cfg, i))
        elif cfg.family in _LAYER_FN:
            x, _, a = _LAYER_FN[cfg.family](x, lp, cfg, positions)
        else:
            raise ValueError(f"forward: unsupported family {cfg.family}")
        aux = aux + a
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, x, cfg), aux


def _embed_inputs(params, tokens, cfg, positions, vision_embeds):
    x = embed(tokens, params["embed"])
    if cfg.family == "vlm" and vision_embeds is not None:
        V = vision_embeds.shape[1]
        x = torch.cat([vision_embeds.to(x.dtype), x[:, V:]], dim=1)
    if positions is None:
        B, S = tokens.shape
        pos = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
        positions = pos.expand(3, B, S) if cfg.mrope else pos
    return x, positions


def _logits(params, x, cfg):
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return unembed(x, w)


# ---------------------------------------------------------------------------
# Prefill — full-sequence forward that also builds the decode cache
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, capacity: int, device="cuda") -> Dict[str, Any]:
    """Zeroed decode cache.  ``capacity`` counts KV slots for attention
    families (a ring of ``local_window`` for hybrid attention blocks);
    SSM/RG-LRU states are O(1)."""
    L = cfg.n_layers
    kv, hd = cfg.n_kv_heads, cfg.head_dim_
    bf16 = dict(dtype=torch.bfloat16, device=device)
    if cfg.family in ("dense", "vlm", "moe"):
        return {
            "k": torch.zeros((L, batch, capacity, kv, hd), **bf16),
            "v": torch.zeros((L, batch, capacity, kv, hd), **bf16),
            "len": 0,
        }
    if cfg.family == "ssm":
        base = ssm_init_cache(cfg, batch, device)
        return {
            "conv": torch.zeros((L,) + tuple(base["conv"].shape), **bf16),
            "h": torch.zeros((L,) + tuple(base["h"].shape), dtype=torch.float32,
                             device=device),
            "len": 0,
        }
    if cfg.family == "hybrid":
        period = len(cfg.block_pattern)
        n_groups, n_tail = divmod(L, period)
        W = min(cfg.local_window, capacity)
        rec = rglru_init_cache(cfg, batch, device)
        cache: Dict[str, Any] = {"len": 0}
        for idx, kind in enumerate(cfg.block_pattern):
            if kind == "rec":
                cache[f"b{idx}_conv"] = rec["conv"].new_zeros((n_groups,) + rec["conv"].shape)
                cache[f"b{idx}_h"] = rec["h"].new_zeros((n_groups,) + rec["h"].shape)
            else:
                cache[f"b{idx}_k"] = torch.zeros((n_groups, batch, W, kv, hd), **bf16)
                cache[f"b{idx}_v"] = torch.zeros((n_groups, batch, W, kv, hd), **bf16)
        for t in range(n_tail):
            if cfg.block_pattern[t] == "rec":
                cache[f"t{t}_conv"] = torch.zeros_like(rec["conv"])
                cache[f"t{t}_h"] = torch.zeros_like(rec["h"])
            else:
                cache[f"t{t}_k"] = torch.zeros((batch, W, kv, hd), **bf16)
                cache[f"t{t}_v"] = torch.zeros((batch, W, kv, hd), **bf16)
        return cache
    raise ValueError(f"init_cache: unsupported family {cfg.family}")


def prefill(
    params, tokens: torch.Tensor, cfg: ModelConfig,
    positions: Optional[torch.Tensor] = None,
    vision_embeds: Optional[torch.Tensor] = None,
    capacity: Optional[int] = None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Returns (last-token logits (B, V), populated cache with len=S)."""
    B, S = tokens.shape
    cap = capacity or S
    x, positions = _embed_inputs(params, tokens, cfg, positions, vision_embeds)

    if cfg.family in ("dense", "vlm", "moe"):
        layer_fn = _LAYER_FN[cfg.family]
        ks, vs = [], []
        for lp in params["layers"]:
            x, (k, v), _ = layer_fn(x, lp, cfg, positions)
            ks.append(pad_cap(k, cap).to(torch.bfloat16))
            vs.append(pad_cap(v, cap).to(torch.bfloat16))
        cache = {"k": torch.stack(ks), "v": torch.stack(vs), "len": S}
    elif cfg.family == "ssm":
        convs, hs = [], []
        for lp in params["layers"]:
            hh = rmsnorm(x, lp["ln"], cfg.norm_eps)
            y, final = ssm_block_with_state(hh, lp["ssm"], cfg)
            x = x + y
            convs.append(final["conv"])
            hs.append(final["h"])
        cache = {"conv": torch.stack(convs), "h": torch.stack(hs), "len": S}
    elif cfg.family == "hybrid":
        cache = init_cache(cfg, B, cap, x.device)
        x = _hybrid_prefill(params, x, cfg, positions, cache)
        cache["len"] = S
    else:
        raise ValueError(cfg.family)

    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(params, x[:, -1:, :], cfg)[:, 0]
    return logits, cache


def pad_cap(k: torch.Tensor, cap: int) -> torch.Tensor:
    """K or V (B, S, KV, hd) fitted to ``cap`` slots: the last ``cap``
    positions, or zero slots after them."""
    S = k.shape[1]
    if S == cap:
        return k
    if S > cap:
        return k[:, S - cap:]
    return F.pad(k, (0, 0, 0, 0, 0, cap - S))


def _slot(cache: Dict[str, Any], prefix: str, g: Optional[int], name: str) -> torch.Tensor:
    """One layer's cache entry (a view, written in place)."""
    t = cache[f"{prefix}_{name}"]
    return t if g is None else t[g]


def _check_tail(cfg: ModelConfig) -> None:
    """The JAX package's prefill and decode take a tail of recurrent
    layers only (a stacked homogeneous tail)."""
    n_tail = cfg.n_layers % len(cfg.block_pattern)
    if any(kind != "rec" for kind in cfg.block_pattern[:n_tail]):
        raise NotImplementedError("heterogeneous hybrid tail")


def _hybrid_prefill(params, x, cfg, positions, cache):
    _check_tail(cfg)
    first = next((i for i, kind in enumerate(cfg.block_pattern) if kind == "attn"), None)
    W = cache[f"b{first}_k"].shape[2] if first is not None else cfg.local_window
    for i, lp in enumerate(params["layers"]):
        prefix, g = hybrid_slot(cfg, i)
        if hybrid_kind(cfg, i) == "rec":
            hh = rmsnorm(x, lp["ln1"], cfg.norm_eps)
            y, final = rglru_block_with_state(hh, lp["rec"], cfg)
            x = x + y
            _slot(cache, prefix, g, "conv").copy_(final["conv"])
            _slot(cache, prefix, g, "h").copy_(final["h"])
        else:
            x, (k, v) = attention_mix(x, lp, cfg, positions, window=cfg.local_window)
            _slot(cache, prefix, g, "k").copy_(pad_cap(k, W))
            _slot(cache, prefix, g, "v").copy_(pad_cap(v, W))
        hh = rmsnorm(x, lp["ln2"], cfg.norm_eps)
        x = x + swiglu(hh, lp["mlp"])
    return x


# ---------------------------------------------------------------------------
# Decode — one token through the stack with cache update
# ---------------------------------------------------------------------------


def decode_step(
    params, tokens: torch.Tensor,  # (B, 1)
    cache: Dict[str, Any], cfg: ModelConfig,
    positions: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Returns (logits (B, V) fp32, the cache updated in place, len + 1)."""
    B = tokens.shape[0]
    pos_now = int(cache["len"])  # position of the incoming token
    if positions is None:
        pos = torch.full((B, 1), pos_now, dtype=torch.int32, device=tokens.device)
        positions = pos.expand(3, B, 1) if cfg.mrope else pos
    x = embed(tokens, params["embed"])

    if cfg.family in ("dense", "vlm", "moe"):
        cap = cache["k"].shape[2]
        slot = min(pos_now, cap - 1)  # dynamic_update_slice clamps the start
        for i, lp in enumerate(params["layers"]):
            ck, cv = cache["k"][i], cache["v"][i]
            hh = rmsnorm(x, lp["ln1"], cfg.norm_eps)
            q, k, v = project_qkv(hh, lp["attn"], cfg, positions)
            ck[:, slot] = k[:, 0].to(ck.dtype)
            cv[:, slot] = v[:, 0].to(cv.dtype)
            o = decode_attention(q, ck, cv, pos_now + 1)
            x = x + output_proj(o, lp["attn"])
            hh = rmsnorm(x, lp["ln2"], cfg.norm_eps)
            if cfg.family == "moe":
                delta, _ = moe_block(hh, lp["moe"], cfg)
            else:
                delta = swiglu(hh, lp["mlp"])
            x = x + delta
    elif cfg.family == "ssm":
        for i, lp in enumerate(params["layers"]):
            hh = rmsnorm(x, lp["ln"], cfg.norm_eps)
            y, nc = ssm_decode_step(hh, {"conv": cache["conv"][i], "h": cache["h"][i]},
                                    lp["ssm"], cfg)
            x = x + y
            cache["conv"][i] = nc["conv"]
            cache["h"][i] = nc["h"]
    elif cfg.family == "hybrid":
        x = _hybrid_decode(params, x, cache, cfg, positions, pos_now)
    else:
        raise ValueError(cfg.family)
    cache["len"] = pos_now + 1

    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(params, x, cfg)[:, 0]
    return logits, cache


def _hybrid_decode(params, x, cache, cfg, positions, pos_now):
    _check_tail(cfg)
    for i, lp in enumerate(params["layers"]):
        prefix, g = hybrid_slot(cfg, i)
        hh = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        if hybrid_kind(cfg, i) == "rec":
            conv, h = _slot(cache, prefix, g, "conv"), _slot(cache, prefix, g, "h")
            y, nc = rglru_decode_step(hh, {"conv": conv, "h": h}, lp["rec"], cfg)
            x = x + y
            conv.copy_(nc["conv"])
            h.copy_(nc["h"])
        else:
            q, k, v = project_qkv(hh, lp["attn"], cfg, positions)
            ck, cv = _slot(cache, prefix, g, "k"), _slot(cache, prefix, g, "v")
            W = ck.shape[1]
            ck[:, pos_now % W] = k[:, 0].to(ck.dtype)
            cv[:, pos_now % W] = v[:, 0].to(cv.dtype)
            o = decode_attention(q, ck, cv, min(pos_now + 1, W))
            x = x + output_proj(o, lp["attn"])
        hh = rmsnorm(x, lp["ln2"], cfg.norm_eps)
        x = x + swiglu(hh, lp["mlp"])
    return x
