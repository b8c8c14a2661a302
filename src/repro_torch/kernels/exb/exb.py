"""Wrapper of the hand-written CUDA exb kernel (``csrc/exb.cu``).

``exb(inp, block_iv, block_iz, split)`` launches the kernel on CUDA
tensors and runs the plain version (:func:`exb_plain`, the module's copy of
``ref.exb_ref``) on CPU tensors; there is no fallback from one to the
other.  ``counter`` counts both.

The tunable pair (block_iv, block_iz) keeps the paper's meaning: the grain
of parallelism, a grid of (iv/block_iv) x (iz/block_iz) CTAs.  ``split``
cuts each (mx, my) plane into that many contiguous pieces, one CTA each,
so the grid holds ``split`` times the CTAs (see the source's note).  A
plane of a multiple of 4 floats is walked in float4 elements, any other in
floats: :func:`plane_elements`.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from .. import _build
from .ref import NAMES3, NAMES4, exb_ref

exb_plain = exb_ref
counter = _build.Counter()

_ARGTYPES = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def plane_elements(plane: int) -> int:
    """Elements the kernel walks in one plane of ``plane`` floats: float4s
    where the plane is a multiple of 4 floats (16-byte rows), else floats."""
    return plane // 4 if plane % 4 == 0 else plane


def _check_inputs(inp: Dict[str, torch.Tensor], block_iv: int, block_iz: int,
                  split: int = 1):
    iv, iz, mx, my = inp["df1_re"].shape
    if block_iv < 1 or block_iz < 1 or iv % block_iv or iz % block_iz:
        raise ValueError(f"blocks ({block_iv},{block_iz}) must divide ({iv},{iz})")
    if split < 1:
        raise ValueError(f"split {split} must be >= 1")
    for name in NAMES4:
        _expect(inp, name, (iv, iz, mx, my))
    for name in NAMES3:
        _expect(inp, name, (iz, mx, my))
    _expect(inp, "vl", (iv,))
    return iv, iz, mx, my


def _expect(inp, name, shape) -> None:
    t = inp[name]
    if tuple(t.shape) != shape or t.dtype != torch.float32:
        raise ValueError(
            f"exb: {name} must be float32 {shape}, got {t.dtype} {tuple(t.shape)}"
        )


def exb_cuda(
    inp: Dict[str, torch.Tensor], block_iv: int = 1, block_iz: int = 16, split: int = 1
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on CUDA tensors (contiguous float32)."""
    iv, iz, mx, my = _check_inputs(inp, block_iv, block_iz, split)
    names = ("vl",) + NAMES4 + NAMES3
    tensors = [inp[n] for n in names]
    if _build.route(tensors, "exb") != "cuda":
        raise ValueError("exb_cuda: inputs must be CUDA tensors")
    for n, t in zip(names, tensors):
        if not t.is_contiguous():
            raise ValueError(f"exb_cuda: {n} must be contiguous")
    out_re = torch.empty((iv, iz, mx, my), dtype=torch.float32, device=tensors[0].device)
    out_im = torch.empty_like(out_re)
    code = _build.function("exb", "exb_launch", _ARGTYPES)(
        *[t.data_ptr() for t in tensors], out_re.data_ptr(), out_im.data_ptr(),
        iv, iz, mx * my, block_iv, block_iz, split, _build.stream_of(out_re),
    )
    _build.check(code, f"exb_launch(block_iv={block_iv}, block_iz={block_iz}, split={split})")
    counter.launched()
    return out_re, out_im


def exb(
    inp: Dict[str, torch.Tensor], block_iv: int = 1, block_iz: int = 16, split: int = 1
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exb update: the CUDA kernel on CUDA tensors, the plain version on
    CPU tensors (tiles are checked either way, so both accept one space)."""
    if _build.route(inp.values(), "exb") == "cuda":
        return exb_cuda(inp, block_iv, block_iz, split)
    _check_inputs(inp, block_iv, block_iz, split)
    counter.ran_plain()
    return exb_plain(inp)


def traffic(iv: int, iz: int, mx: int, my: int, block_iv: int) -> Tuple[float, float]:
    """(flops, bytes) of one call: the 3-D fields are read once per iv block."""
    n4 = iv * iz * mx * my
    n3 = iz * mx * my
    return 24.0 * n4, 4.0 * (6 * n4 + 8 * n3 * (iv // block_iv) + iv)
