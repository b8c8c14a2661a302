"""ModelConfig — one dataclass describing every architecture in the pool.

The 10 assigned architectures span dense GQA, MoE, SSM (Mamba-1), hybrid
(RG-LRU + local attention), encoder-decoder (Whisper), and VLM (M-RoPE)
families; this config is the superset of their knobs.  Concrete instances
live in ``repro_torch/configs/<arch>.py`` (full + smoke-reduced pairs).
This module is the port's copy of ``repro.models.config``, as is; the port
imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None          # defaults to d_model // n_heads
    qkv_bias: bool = False                  # qwen2.5
    qk_norm: bool = False                   # qwen3
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_groups: int = 1  # GShard-style dispatch groups (set = data degree at scale)

    # SSM (Mamba-1)
    ssm_state: int = 0
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None           # defaults to ceil(d_model / 16)

    # Hybrid (RecurrentGemma): repeating block pattern, e.g. ("rglru","rglru","attn")
    block_pattern: Tuple[str, ...] = ()
    lru_width: Optional[int] = None         # defaults to d_model
    local_window: int = 2048

    # Encoder-decoder (Whisper)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_len: int = 1500                 # 30 s of audio at 50 Hz after conv stub

    # VLM (Qwen2-VL)
    mrope: bool = False
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)  # t/h/w split of head_dim/2
    n_vision_tokens: int = 256              # stubbed patch embeddings per sample

    # numerics / structure
    dtype: str = "bfloat16"
    remat: str = "full"                     # none | full  (PP at train time)
    scan_layers: bool = True                # scan-over-layers (compile economy)
    attn_block_q: int = 512                 # XLA blocked-attention tile (PP)
    attn_block_kv: int = 1024

    def __post_init__(self) -> None:
        if self.family not in ("dense", "moe", "ssm", "hybrid", "audio", "vlm"):
            raise ValueError(f"unknown family {self.family!r}")
        if self.family != "ssm":
            if self.n_heads % max(1, self.n_kv_heads):
                raise ValueError("n_heads must be divisible by n_kv_heads")
        if self.family == "moe" and (self.n_experts <= 0 or self.top_k <= 0):
            raise ValueError("moe family needs n_experts and top_k")
        if self.family == "hybrid" and not self.block_pattern:
            raise ValueError("hybrid family needs a block_pattern")

    # -- derived ---------------------------------------------------------------

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

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch supports O(seq) decode state (long_500k eligible)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decode(self) -> bool:
        return True  # all assigned archs are decoder-bearing

    def with_(self, **kwargs) -> "ModelConfig":
        return dataclasses.replace(self, **kwargs)

    # -- parameter counting (for 6ND MODEL_FLOPS) --------------------------------

    def param_count(self, active_only: bool = False) -> int:
        """Analytic parameter count; active_only counts top_k experts (MoE)."""
        from . import model as _model  # late import to avoid cycle

        return _model.analytic_param_count(self, active_only=active_only)
