"""The yardstick: the card's published peaks and the work of each step and
kernel call, counted from the configuration and the shapes.

Frozen copies, so that a later change to the program cannot move what its
numbers are read against:

* the peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates),
  as ``repro_torch/core/arch.py`` holds them;
* :func:`param_count` and :func:`step_flops`: ``repro_torch.models.model``'s
  ``analytic_param_count`` and ``analytic_step_flops`` (useful FLOPs of a
  step: 6·N·D train / 2·N·D forward over the active parameters, plus the
  attention and scan terms 6·N·D leaves out, causal attention at half);
* :func:`flash_bwd_bound_s`: ``chip_smoke.py``'s ``flash_bwd_bound_ms``;
* :func:`ssm_scan_bound_s`: the forward's operations and bytes of
  ``repro_torch/kernels/ssm_scan/ssm_scan.py``'s ``traffic``, with the
  final state it writes in a prefill.

A roofline share counts the work the call's shapes imply, each input read
once and each output written once, whatever a kernel reads again.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

PEAK_BF16_FLOPS = 989e12      # dense bf16 tensor-core rate
PEAK_TF32_FLOPS = 495e12      # dense TF32 tensor-core rate
PEAK_FP32_FLOPS = 67e12       # float32 on the CUDA cores
HBM_BYTES_PER_S = 3.35e12     # HBM3


@dataclass(frozen=True)
class Sizes:
    """The sizes of a configuration that the work depends on (the ``model``
    block of a configuration file)."""

    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    qk_norm: bool = False
    tie_embeddings: bool = False
    n_experts: int = 0
    top_k: int = 0
    ssm_state: int = 0
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None
    block_pattern: Tuple[str, ...] = ()
    lru_width: Optional[int] = None
    local_window: int = 2048
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_len: int = 1500
    extra: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def of(cls, model: Dict[str, Any]) -> "Sizes":
        known = set(cls.__dataclass_fields__) - {"extra"}
        kw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in model.items() if k in known}
        return cls(**kw, extra={k: v for k, v in model.items() if k not in known})

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def dt_rank_(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def lru_width_(self) -> int:
        return self.lru_width or self.d_model


def param_count(cfg: Sizes, active_only: bool = False) -> int:
    d, ff, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    attn = d * h * hd + 2 * d * kv * hd + h * hd * d
    if cfg.qkv_bias:
        attn += h * hd + 2 * kv * hd
    if cfg.qk_norm:
        attn += 2 * hd
    embed = V * d if cfg.tie_embeddings else 2 * V * d
    if cfg.family in ("dense", "vlm"):
        return embed + cfg.n_layers * (attn + 3 * d * ff + 2 * d) + d
    if cfg.family == "moe":
        n_e = cfg.top_k if active_only else cfg.n_experts
        return embed + cfg.n_layers * (attn + d * cfg.n_experts + 3 * n_e * d * ff + 2 * d) + d
    if cfg.family == "ssm":
        di, N, R, K = cfg.d_inner, cfg.ssm_state, cfg.dt_rank_, cfg.d_conv
        per_layer = (2 * d * di + K * di + di + di * (R + 2 * N) + R * di + di
                     + di * N + di + di * d + d)
        return embed + cfg.n_layers * per_layer + d
    if cfg.family == "hybrid":
        w, K = cfg.lru_width_, cfg.d_conv
        rec = 2 * d * w + K * w + w + 2 * (w * w + w) + w + w * d
        mlp = 3 * d * ff
        n_attn = sum(1 for i in range(cfg.n_layers)
                     if cfg.block_pattern[i % len(cfg.block_pattern)] == "attn")
        n_rec = cfg.n_layers - n_attn
        return embed + n_rec * (rec + mlp + 2 * d) + n_attn * (attn + mlp + 2 * d) + d
    if cfg.family == "audio":
        enc_layer = attn + 2 * d * ff + ff + 2 * d + 4 * d
        dec_layer = 2 * attn + 2 * d * ff + ff + 2 * d + 6 * d
        return (V * d + cfg.encoder_len * d + cfg.n_encoder_layers * enc_layer
                + cfg.n_layers * dec_layer + 4 * d)
    raise ValueError(cfg.family)


def step_flops(cfg: Sizes, kind: str, batch: int, seq: int) -> float:
    """Useful FLOPs of one step of ``kind`` ("train", "prefill", "decode";
    for decode ``seq`` is the context the token attends to)."""
    n_active = param_count(cfg, active_only=True)
    train = kind == "train"
    fwd_mult = 3.0 if train else 1.0
    D = batch * (1 if kind == "decode" else seq)
    total = (6.0 if train else 2.0) * n_active * D
    h, hd = cfg.n_heads, cfg.head_dim_
    L_attn, window = 0, None
    if cfg.family in ("dense", "moe", "vlm"):
        L_attn = cfg.n_layers
    elif cfg.family == "hybrid":
        L_attn = sum(1 for i in range(cfg.n_layers)
                     if cfg.block_pattern[i % len(cfg.block_pattern)] == "attn")
        window = cfg.local_window
    if L_attn:
        if kind == "decode":
            ctx = min(seq, window) if window else seq
            total += L_attn * batch * ctx * h * hd * 4.0
        elif window and seq > window:
            total += L_attn * batch * seq * window * h * hd * 4.0 * fwd_mult
        else:
            total += L_attn * batch * seq * seq * h * hd * 4.0 * 0.5 * fwd_mult
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
    steps = 1 if kind == "decode" else seq
    if cfg.family == "ssm":
        total += cfg.n_layers * batch * steps * cfg.d_inner * cfg.ssm_state * 6.0 * fwd_mult
    if cfg.family == "hybrid":
        total += (cfg.n_layers - L_attn) * batch * steps * cfg.lru_width_ * 8.0 * fwd_mult
    return float(total)


def flash_bwd_bound_s(B: int, S: int, H: int, KV: int, hd: int, elt: int = 2) -> float:
    """Least time of one causal flash backward call: five products of
    2·S²·hd·H/2 FLOPs a batch row at the bf16 tensor-core rate (at a third
    of the TF32 rate in float32, 3xTF32), against q, o, do, k, v and lse
    read and dq, dk, dv written once."""
    flops = 5 * 2.0 * B * H * S * S * hd / 2
    ops = flops / PEAK_BF16_FLOPS if elt == 2 else 3 * flops / PEAK_TF32_FLOPS
    by_bytes = (elt * B * S * hd * (4 * H + 4 * KV) + 4 * B * H * S) / HBM_BYTES_PER_S
    return max(ops, by_bytes)


def ssm_scan_bound_s(B: int, S: int, D: int, N: int, elt: int = 4,
                     final_state: bool = True) -> float:
    """Least time of one selective-scan forward call: 7 operations a step
    and state and 3 a step and channel at the float32 rate, against x, dt,
    Bc, Cc read and y written once (``elt`` bytes an element), the final
    state (B, D, N) float32 written once.  A and D (read once per call, a
    few hundred KB) are left out, so a share of this bound never counts
    more than the call must move."""
    flops = 7.0 * B * S * D * N + 3.0 * B * S * D
    bytes_ = elt * (3.0 * B * S * D + 2.0 * B * S * N)
    if final_state:
        bytes_ += 4.0 * B * D * N
    return max(flops / PEAK_FP32_FLOPS, bytes_ / HBM_BYTES_PER_S)


def share(bound_s: float, spent_s: float) -> Optional[float]:
    """``bound_s / spent_s`` in percent, or None where nothing was spent."""
    if not spent_s or spent_s <= 0 or not math.isfinite(spent_s):
        return None
    return 100.0 * bound_s / spent_s
