"""Whisper-style encoder–decoder (whisper-large-v3 backbone).

The port of ``repro.models.encdec``.  The conv frontend is a stub, as in
the JAX package: the caller supplies log-mel frame embeddings
(B, encoder_len, d_model); the encoder is a bidirectional transformer over
them with a learned positional table, the decoder a causal transformer
with cross-attention and sinusoidal positions; embeddings are tied.  The
decoder's causal self-attention takes the kernel route
(:func:`~.attention.causal_attention`); the encoder's non-causal
attention and the cross attention are torch ops, as the JAX package uses
XLA there.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from .attention import (
    attn_spec, causal_attention, cross_attention, decode_attention, full_attention, output_proj,
    project_qkv,
)
from .config import ModelConfig
from .layers import dot, embed, embed_spec, gelu_mlp, gelu_mlp_spec, layernorm, unembed
from .spec import ParamSpec
from .transformer import pad_cap


def _ln_spec(d: int) -> Dict[str, ParamSpec]:
    return {
        "scale": ParamSpec((d,), ("embed",), init="ones"),
        "bias": ParamSpec((d,), ("embed",), init="zeros"),
    }


def encdec_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    return {
        "embed": embed_spec(cfg),
        "enc_pos": ParamSpec((cfg.encoder_len, d), ("frames", "embed"), init_scale=0.02),
        "enc_layers": [
            {"ln1": _ln_spec(d), "attn": attn_spec(cfg), "ln2": _ln_spec(d),
             "mlp": gelu_mlp_spec(d, cfg.d_ff)}
            for _ in range(cfg.n_encoder_layers)
        ],
        "enc_final_ln": _ln_spec(d),
        "dec_layers": [
            {"ln1": _ln_spec(d), "self_attn": attn_spec(cfg), "lnx": _ln_spec(d),
             "cross_attn": attn_spec(cfg, cross=True), "ln2": _ln_spec(d),
             "mlp": gelu_mlp_spec(d, cfg.d_ff)}
            for _ in range(cfg.n_layers)
        ],
        "dec_final_ln": _ln_spec(d),
    }


def _sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    half = d // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=positions.device)
                      / max(1, half - 1))
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _decoder_inputs(params, tokens: torch.Tensor, pos: torch.Tensor, cfg: ModelConfig):
    return embed(tokens, params["embed"]) + _sinusoid(pos, cfg.d_model).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def encode(params, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """frames: (B, enc_len, d) stubbed embeddings -> encoder states."""
    x = frames.to(torch.bfloat16) + params["enc_pos"].to(torch.bfloat16)
    for lp in params["enc_layers"]:
        hh = layernorm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = project_qkv(hh, lp["attn"], cfg, positions=None)  # no RoPE
        x = x + output_proj(full_attention(q, k, v, causal=False), lp["attn"])
        hh = layernorm(x, lp["ln2"], cfg.norm_eps)
        x = x + gelu_mlp(hh, lp["mlp"])
    return layernorm(x, params["enc_final_ln"], cfg.norm_eps)


def _cross_kv(enc_out: torch.Tensor, lp_cross):
    return dot(enc_out, lp_cross["wk"]), dot(enc_out, lp_cross["wv"])


# ---------------------------------------------------------------------------
# Decoder (forward / prefill / decode)
# ---------------------------------------------------------------------------


def _decoder_layer(h, lp, cfg: ModelConfig, enc_out):
    hh = layernorm(h, lp["ln1"], cfg.norm_eps)
    q, k, v = project_qkv(hh, lp["self_attn"], cfg, positions=None)
    h = h + output_proj(causal_attention(q, k, v), lp["self_attn"])
    hh = layernorm(h, lp["lnx"], cfg.norm_eps)
    qx = dot(hh, lp["cross_attn"]["wq"])
    kx, vx = _cross_kv(enc_out, lp["cross_attn"])
    h = h + output_proj(cross_attention(qx, kx, vx), lp["cross_attn"])
    hh = layernorm(h, lp["ln2"], cfg.norm_eps)
    return h + gelu_mlp(hh, lp["mlp"]), (k, v), (kx, vx)


def forward(
    params, frames: torch.Tensor, tokens: torch.Tensor, cfg: ModelConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logits (B,S,V) fp32, aux=0)."""
    enc_out = encode(params, frames, cfg)
    B, S = tokens.shape
    pos = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
    x = _decoder_inputs(params, tokens, pos, cfg)
    for lp in params["dec_layers"]:
        x = _decoder_layer(x, lp, cfg, enc_out)[0]
    x = layernorm(x, params["dec_final_ln"], cfg.norm_eps)
    logits = unembed(x, params["embed"].T)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def init_cache(cfg: ModelConfig, batch: int, capacity: int, device="cuda") -> Dict[str, Any]:
    L, kv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim_
    bf16 = dict(dtype=torch.bfloat16, device=device)
    return {
        "self_k": torch.zeros((L, batch, capacity, kv, hd), **bf16),
        "self_v": torch.zeros((L, batch, capacity, kv, hd), **bf16),
        "cross_k": torch.zeros((L, batch, cfg.encoder_len, kv, hd), **bf16),
        "cross_v": torch.zeros((L, batch, cfg.encoder_len, kv, hd), **bf16),
        "len": 0,
    }


def prefill(
    params, frames: torch.Tensor, tokens: torch.Tensor, cfg: ModelConfig,
    capacity: Optional[int] = None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    enc_out = encode(params, frames, cfg)
    B, S = tokens.shape
    cap = capacity or S
    pos = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
    x = _decoder_inputs(params, tokens, pos, cfg)
    caches: Dict[str, list] = {"self_k": [], "self_v": [], "cross_k": [], "cross_v": []}
    for lp in params["dec_layers"]:
        x, (k, v), (kx, vx) = _decoder_layer(x, lp, cfg, enc_out)
        for key, t in (("self_k", pad_cap(k, cap)), ("self_v", pad_cap(v, cap)),
                       ("cross_k", kx), ("cross_v", vx)):
            caches[key].append(t.to(torch.bfloat16))
    x = layernorm(x, params["dec_final_ln"], cfg.norm_eps)
    logits = unembed(x[:, -1:, :], params["embed"].T)[:, 0]
    cache: Dict[str, Any] = {key: torch.stack(ts) for key, ts in caches.items()}
    cache["len"] = S
    return logits, cache


def decode_step(
    params, tokens: torch.Tensor,  # (B, 1)
    cache: Dict[str, Any], cfg: ModelConfig,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """(logits (B, V) fp32, the cache updated in place, len + 1)."""
    B = tokens.shape[0]
    pos_now = int(cache["len"])
    pos = torch.full((B, 1), pos_now, dtype=torch.int32, device=tokens.device)
    x = _decoder_inputs(params, tokens, pos, cfg)
    slot = min(pos_now, cache["self_k"].shape[2] - 1)  # dynamic_update_slice clamps
    for i, lp in enumerate(params["dec_layers"]):
        sk, sv = cache["self_k"][i], cache["self_v"][i]
        hh = layernorm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = project_qkv(hh, lp["self_attn"], cfg, positions=None)
        sk[:, slot] = k[:, 0].to(sk.dtype)
        sv[:, slot] = v[:, 0].to(sv.dtype)
        x = x + output_proj(decode_attention(q, sk, sv, pos_now + 1), lp["self_attn"])
        hh = layernorm(x, lp["lnx"], cfg.norm_eps)
        qx = dot(hh, lp["cross_attn"]["wq"])
        ox = decode_attention(qx, cache["cross_k"][i], cache["cross_v"][i], cfg.encoder_len)
        x = x + output_proj(ox, lp["cross_attn"])
        hh = layernorm(x, lp["ln2"], cfg.norm_eps)
        x = x + gelu_mlp(hh, lp["mlp"])
    cache["len"] = pos_now + 1
    x = layernorm(x, params["dec_final_ln"], cfg.norm_eps)
    return unembed(x, params["embed"].T)[:, 0], cache
