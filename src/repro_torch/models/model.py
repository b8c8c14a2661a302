"""Unified model API over the 10-arch zoo.

The port of ``repro.models.model``.  Entry points:

* :func:`param_specs` — tree of ParamSpec (no allocation);
  :func:`init_params` draws it on a device from a ``torch.Generator``.
* :func:`forward` / :func:`train_loss` — logits and CE (+ MoE aux) for one
  batch, differentiable as the JAX ones are (``repro_torch.runtime.train``
  takes their gradient); on the card causal attention and the two scans
  run forward and backward on their kernels (:mod:`.route`).
* :func:`prefill_fn` / :func:`decode_fn` / :func:`init_cache` — serving.
* :func:`make_concrete_batch` — random inputs of one cell, from a
  ``torch.Generator``.
* :func:`analytic_param_count` / :func:`analytic_step_flops` — N and the
  useful FLOPs of a step (plain Python, copied as is).
* :func:`cache_batch_axis` — where each decode-cache leaf keeps its batch
  (serving splits, joins, gathers and scatters caches by it).

Left out, as the JAX package's XLA side: ``input_specs`` /
``input_logical_axes`` (the dry-run's sharded stand-ins).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from . import encdec, transformer
from .config import ModelConfig
from .spec import Params, init_params as _init_params


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    if cfg.is_encoder_decoder:
        return encdec.encdec_specs(cfg)
    return transformer.decoder_specs(cfg)


def init_params(cfg: ModelConfig, generator: torch.Generator, device: Any = "cuda") -> Params:
    """The model's parameters on ``device``, drawn from ``generator``."""
    return _init_params(param_specs(cfg), generator, device)


def analytic_param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    d, ff, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    attn = d * h * hd + 2 * d * kv * hd + h * hd * d
    if cfg.qkv_bias:
        attn += h * hd + 2 * kv * hd
    if cfg.qk_norm:
        attn += 2 * hd
    embed = V * d if cfg.tie_embeddings else 2 * V * d

    if cfg.family in ("dense", "vlm"):
        per_layer = attn + 3 * d * ff + 2 * d
        return embed + cfg.n_layers * per_layer + d
    if cfg.family == "moe":
        n_e = cfg.top_k if active_only else cfg.n_experts
        per_layer = attn + d * cfg.n_experts + 3 * n_e * d * ff + 2 * d
        return embed + cfg.n_layers * per_layer + d
    if cfg.family == "ssm":
        di, N, R, K = cfg.d_inner, cfg.ssm_state, cfg.dt_rank_, cfg.d_conv
        per_layer = (
            2 * d * di + K * di + di + di * (R + 2 * N) + R * di + di
            + di * N + di + di * d + d
        )
        return embed + cfg.n_layers * per_layer + d
    if cfg.family == "hybrid":
        w, K = cfg.lru_width_, cfg.d_conv
        rec = 2 * d * w + K * w + w + 2 * (w * w + w) + w + w * d
        mlp = 3 * d * ff
        per_rec = rec + mlp + 2 * d
        per_attn = attn + mlp + 2 * d
        n_attn = sum(
            1
            for i in range(cfg.n_layers)
            if cfg.block_pattern[i % len(cfg.block_pattern)] == "attn"
        )
        n_rec = cfg.n_layers - n_attn
        return embed + n_rec * per_rec + n_attn * per_attn + d
    if cfg.family == "audio":
        enc_layer = attn + 2 * d * ff + ff + 2 * d + 4 * d
        dec_layer = 2 * attn + 2 * d * ff + ff + 2 * d + 6 * d
        return (
            V * d
            + cfg.encoder_len * d
            + cfg.n_encoder_layers * enc_layer
            + cfg.n_layers * dec_layer
            + 4 * d
        )
    raise ValueError(cfg.family)


def analytic_step_flops(cfg: ModelConfig, kind: str, batch: int, seq: int) -> float:
    """Useful FLOPs of one step: weight matmuls (6·N·D train / 2·N·D fwd,
    N active) **plus** the sequence-interaction terms 6·N·D ignores —
    attention score/value flops (dominant at 32k+), SSM/RG-LRU scan flops.

    This is the MODEL_FLOPS numerator for §Roofline's useful-compute ratio;
    causal masking is counted at 1/2 (only the lower triangle is useful).
    """
    n_active = analytic_param_count(cfg, active_only=True)
    train = kind == "train"
    fwd_mult = 3.0 if train else 1.0  # bwd ≈ 2× fwd
    D = batch * (1 if kind == "decode" else seq)
    total = (6.0 if train else 2.0) * n_active * D

    h, hd = cfg.n_heads, cfg.head_dim_
    L_attn = 0
    window = None
    if cfg.family in ("dense", "moe", "vlm"):
        L_attn = cfg.n_layers
    elif cfg.family == "hybrid":
        L_attn = sum(
            1 for i in range(cfg.n_layers)
            if cfg.block_pattern[i % len(cfg.block_pattern)] == "attn"
        )
        window = cfg.local_window

    if L_attn:
        if kind == "decode":
            ctx = min(seq, window) if window else seq
            attn = L_attn * batch * ctx * h * hd * 4.0
        else:
            if window and seq > window:
                attn = L_attn * batch * seq * window * h * hd * 4.0 * fwd_mult
            else:
                attn = L_attn * batch * seq * seq * h * hd * 4.0 * 0.5 * fwd_mult
        total += attn

    if cfg.is_encoder_decoder:
        E = cfg.encoder_len
        enc = cfg.n_encoder_layers * batch * E * E * h * hd * 4.0 * fwd_mult
        dec_self = cfg.n_layers * batch * (
            seq * hd * h * 4.0 if kind == "decode" else seq * seq * hd * h * 2.0
        ) * (fwd_mult if kind != "decode" else 1.0)
        cross = cfg.n_layers * batch * (
            E * hd * h * 4.0 if kind == "decode" else seq * E * hd * h * 4.0
        ) * (fwd_mult if kind != "decode" else 1.0)
        total += (0.0 if kind == "decode" else enc) + dec_self + cross

    if cfg.family == "ssm":
        steps = 1 if kind == "decode" else seq
        total += cfg.n_layers * batch * steps * cfg.d_inner * cfg.ssm_state * 6.0 * fwd_mult
    if cfg.family == "hybrid":
        L_rec = cfg.n_layers - L_attn
        steps = 1 if kind == "decode" else seq
        total += L_rec * batch * steps * cfg.lru_width_ * 8.0 * fwd_mult

    return float(total)


# ---------------------------------------------------------------------------
# Losses & serving
# ---------------------------------------------------------------------------


def forward(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """(logits (B,S,V) fp32, aux loss) for one batch."""
    if cfg.is_encoder_decoder:
        return encdec.forward(params, batch["frames"], batch["tokens"], cfg)
    return transformer.forward(
        params, batch["tokens"], cfg,
        positions=batch.get("positions"), vision_embeds=batch.get("vision_embeds"),
    )


def train_loss(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig) -> torch.Tensor:
    """Mean next-token CE (+ MoE aux)."""
    logits, aux = forward(params, batch, cfg)
    return _ce(logits, batch["targets"], batch.get("loss_mask")) + aux


def _ce(logits: torch.Tensor, targets: torch.Tensor, mask: Optional[torch.Tensor]):
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        m = mask.float()
        return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)
    return torch.mean(nll)


@torch.no_grad()
def prefill_fn(params, batch, cfg: ModelConfig, capacity: Optional[int] = None):
    """Prefill; ``capacity`` (>= prompt len) sizes the returned KV cache so a
    request can decode in place without a cache reallocation."""
    if cfg.is_encoder_decoder:
        return encdec.prefill(params, batch["frames"], batch["tokens"], cfg, capacity=capacity)
    return transformer.prefill(
        params, batch["tokens"], cfg,
        positions=batch.get("positions"), vision_embeds=batch.get("vision_embeds"),
        capacity=capacity,
    )


@torch.no_grad()
def decode_fn(params, batch, cache, cfg: ModelConfig):
    """One token: (logits (B, V) fp32, the cache updated in place)."""
    if cfg.is_encoder_decoder:
        return encdec.decode_step(params, batch["tokens"], cache, cfg)
    return transformer.decode_step(params, batch["tokens"], cache, cfg,
                                   positions=batch.get("positions"))


def init_cache(cfg: ModelConfig, batch: int, capacity: int, device: Any = "cuda"):
    if cfg.is_encoder_decoder:
        return encdec.init_cache(cfg, batch, capacity, device)
    return transformer.init_cache(cfg, batch, capacity, device)


# the batch axis of the cache leaves whose layout the name fixes:
# attention K/V (layers, batch, slots, kv_heads, head_dim); the SSM's conv
# (layers, batch, K-1, d_inner) and h (layers, batch, d_inner, N)
_CACHE_BATCH_AXIS = {"k": 1, "v": 1, "self_k": 1, "self_v": 1, "cross_k": 1, "cross_v": 1,
                     "conv": 1, "h": 1}


def cache_batch_axis(key: str, rank: int) -> Optional[int]:
    """Index of the batch axis in one decode-cache leaf of rank ``rank``, or
    None for a ``len`` shared by every row (an int).  As the JAX package's:
    stacked per-layer leaves are (layers, B, ...), the hybrid's pattern
    slots ``b{idx}_*`` (groups, B, ...) and its tail ``t{t}_*`` (B, ...),
    keyed by the name's suffix and the rank.  A per-row ``len``, a (B,)
    tensor, has its batch on axis 0."""
    if key == "len":
        return 0 if rank == 1 else None
    if key in _CACHE_BATCH_AXIS and rank == 5 - (key in ("conv", "h")):
        return _CACHE_BATCH_AXIS[key]
    suffix = key.split("_")[-1]
    if suffix in ("k", "v"):
        return rank - 4
    if suffix == "conv":
        return rank - 3
    if suffix == "h":
        return 1 if rank == 4 else rank - 2
    return None


def make_concrete_batch(
    generator: torch.Generator, cfg: ModelConfig, kind: str, global_batch: int, seq_len: int,
    device: Any = "cuda",
) -> Dict[str, Any]:
    """Random concrete inputs of one cell (the JAX ``make_concrete_batch``'s
    leaves): token ids uniform in [0, vocab - 1), embeddings standard
    normal in bf16; ``kind`` is "train", "prefill" or "decode" (for
    decode, ``seq_len`` is the cache's length, holding seq_len - 1 tokens)."""
    B, S = global_batch, seq_len

    def ints(*shape):
        return torch.randint(0, max(2, cfg.vocab_size - 1), shape, generator=generator,
                             device=device)

    def normal(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=device).to(dtype)

    def token_batch(seq: int) -> Dict[str, Any]:
        d: Dict[str, Any] = {"tokens": ints(B, seq)}
        if cfg.family == "vlm":
            d["vision_embeds"] = normal(B, cfg.n_vision_tokens, cfg.d_model)
            d["positions"] = ints(3, B, seq)
        if cfg.is_encoder_decoder:
            d["frames"] = normal(B, cfg.encoder_len, cfg.d_model)
        return d

    if kind == "train":
        batch = token_batch(S)
        batch["targets"] = ints(B, S)
        mask = torch.ones((B, S), dtype=torch.float32, device=device)
        if cfg.family == "vlm":
            mask[:, :cfg.n_vision_tokens] = 0.0
        batch["loss_mask"] = mask
        return {"batch": batch}
    if kind == "prefill":
        return {"batch": token_batch(S)}
    if kind == "decode":
        cache = init_cache(cfg, B, S, device)
        for key, t in cache.items():
            if isinstance(t, torch.Tensor):
                t.copy_(normal(*t.shape, dtype=t.dtype))
        cache["len"] = S - 1  # a plausible populated cache: len = capacity - 1
        return {"batch": token_batch(1), "cache": cache}
    raise ValueError(f"unknown kind {kind!r}")
