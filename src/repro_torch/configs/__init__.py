"""Assigned-architecture registry: 10 archs × 4 input shapes = 40 cells.

The port's copy of ``repro.configs`` (it imports nothing of the JAX
package): the same ``FULL``/``SMOKE`` pairs, built on the port's
:class:`~repro_torch.models.config.ModelConfig`.

Every arch module exports ``FULL`` (the exact published config) and ``SMOKE``
(a reduced same-family config for CPU tests).  Shape cells follow the
assignment; skip rules (docs/design.md §4): ``long_500k`` only for sub-quadratic
families (ssm, hybrid).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.models.config import ModelConfig

from . import (
    falcon_mamba_7b,
    granite_moe_1b_a400m,
    llama3_405b,
    llama4_scout_17b_a16e,
    qwen2_5_32b,
    qwen2_vl_2b,
    qwen3_0_6b,
    recurrentgemma_2b,
    tinyllama_1_1b,
    whisper_large_v3,
)

_MODULES = {
    "llama3-405b": llama3_405b,
    "tinyllama-1.1b": tinyllama_1_1b,
    "qwen2.5-32b": qwen2_5_32b,
    "qwen3-0.6b": qwen3_0_6b,
    "llama4-scout-17b-a16e": llama4_scout_17b_a16e,
    "granite-moe-1b-a400m": granite_moe_1b_a400m,
    "whisper-large-v3": whisper_large_v3,
    "recurrentgemma-2b": recurrentgemma_2b,
    "falcon-mamba-7b": falcon_mamba_7b,
    "qwen2-vl-2b": qwen2_vl_2b,
}

ARCH_IDS: Tuple[str, ...] = tuple(_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = _MODULES[arch]
    return mod.SMOKE if smoke else mod.FULL


@dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}


def cells_for(arch: str) -> List[ShapeCell]:
    """The runnable shape cells for an arch, applying the skip rules."""
    cfg = get_config(arch)
    cells = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.sub_quadratic:
        cells.append(SHAPES["long_500k"])
    return cells


def all_cells() -> List[Tuple[str, ShapeCell]]:
    return [(arch, cell) for arch in ARCH_IDS for cell in cells_for(arch)]


def skipped_cells() -> List[Tuple[str, str, str]]:
    """(arch, shape, reason) for every assigned-but-skipped cell."""
    out = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        if not cfg.sub_quadratic:
            out.append(
                (arch, "long_500k", "pure full attention (needs sub-quadratic)")
            )
    return out
