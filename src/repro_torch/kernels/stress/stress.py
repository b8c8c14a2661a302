"""Wrapper of the hand-written CUDA stress kernel (``csrc/stress.cu``).

``stress(inp, block_k, block_j)`` launches the kernel on CUDA tensors and
runs the plain version (:func:`stress_plain`, the module's copy of
``ref.stress_ref``) on CPU tensors; there is no fallback from one to the
other.  ``counter`` counts both.

The tunable pair (block_k, block_j) keeps the paper's meaning: the grain
of parallelism, a grid of (nk/block_k) x (nj/block_j) CTAs, each walking
its tile with the contiguous ``ni`` kept whole (see the source's note).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from .. import _build
from .ref import INPUT_NAMES, OUTPUT_NAMES, stress_ref

stress_plain = stress_ref
counter = _build.Counter()

_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _check_inputs(inp: Dict[str, torch.Tensor], block_k: int, block_j: int):
    missing = [n for n in INPUT_NAMES if n not in inp]
    if missing:
        raise ValueError(f"stress: missing fields {missing}")
    shape = tuple(inp["Sxx"].shape)
    if len(shape) != 3:
        raise ValueError(f"stress: fields must be (nk, nj, ni), got {shape}")
    nk, nj, ni = shape
    if block_k < 1 or block_j < 1 or nk % block_k or nj % block_j:
        raise ValueError(f"blocks ({block_k},{block_j}) must divide ({nk},{nj})")
    for name in INPUT_NAMES:
        t = inp[name]
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(
                f"stress: {name} must be float32 {shape}, got {t.dtype} {tuple(t.shape)}"
            )
    return nk, nj, ni


def stress_cuda(
    inp: Dict[str, torch.Tensor], block_k: int = 8, block_j: int = 64
) -> Dict[str, torch.Tensor]:
    """Launch the CUDA kernel on CUDA tensors (contiguous float32)."""
    nk, nj, ni = _check_inputs(inp, block_k, block_j)
    tensors = [inp[n] for n in INPUT_NAMES]
    if _build.route(tensors, "stress") != "cuda":
        raise ValueError("stress_cuda: inputs must be CUDA tensors")
    for n, t in zip(INPUT_NAMES, tensors):
        if not t.is_contiguous():
            raise ValueError(f"stress_cuda: {n} must be contiguous")
    outs = [torch.empty_like(tensors[0]) for _ in OUTPUT_NAMES]
    ins = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    outp = (ctypes.c_void_p * len(outs))(*[t.data_ptr() for t in outs])
    code = _build.function("stress", "stress_launch", _ARGTYPES)(
        ins, outp, nk, nj, ni, block_k, block_j, _build.stream_of(outs[0]),
    )
    _build.check(code, f"stress_launch(block_k={block_k}, block_j={block_j})")
    counter.launches += 1
    return dict(zip(OUTPUT_NAMES, outs))


def stress(
    inp: Dict[str, torch.Tensor], block_k: int = 8, block_j: int = 64
) -> Dict[str, torch.Tensor]:
    """The stress update: the CUDA kernel on CUDA tensors, the plain version
    on CPU tensors (tiles are checked either way, so both accept one space)."""
    if _build.route(inp.values(), "stress") == "cuda":
        return stress_cuda(inp, block_k, block_j)
    _check_inputs(inp, block_k, block_j)
    counter.plain_calls += 1
    return stress_plain(inp)


def traffic(nk: int, nj: int, ni: int) -> Tuple[float, float]:
    """(flops, bytes) of one call: 30 flops a cell; each of the 17 input
    fields read once and each of the 6 outputs written once."""
    cells = float(nk * nj * ni)
    return 30.0 * cells, 4.0 * (len(INPUT_NAMES) + len(OUTPUT_NAMES)) * cells
