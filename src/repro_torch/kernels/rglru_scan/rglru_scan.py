"""Wrapper of the hand-written CUDA RG-LRU scan kernel (``csrc/rglru_scan.cu``).

``rglru_scan(x, r, i, lam, block_w, chunk)`` launches the kernel on CUDA
tensors and runs the plain version (:func:`rglru_scan_plain`, the module's
copy of ``ref.rglru_scan_ref``) on CPU tensors; there is no fallback from
one to the other.  ``counter`` counts both.

One thread per (batch, channel) carries h over the whole sequence; a CTA
holds ``block_w`` channels and stages ``chunk`` time steps per loop trip
in shared memory.  As in the JAX kernel, each tile is first ``min``'d to
its extent and must then divide it.  The kernel takes float32 only.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import _build
from .ref import rglru_scan_ref

rglru_scan_plain = rglru_scan_ref
counter = _build.Counter()

MAX_THREADS = 1024  # threads of one CTA: block_w
SMEM_LIMIT = 232_448  # H100 opt-in shared memory per block

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def smem_bytes(block_w: int, chunk: int) -> int:
    """Dynamic shared memory of one CTA (``smem_bytes`` in the source):
    ``chunk`` steps of x, r and i for ``block_w`` channels."""
    return 3 * chunk * block_w * 4


def _check(x, r, i, lam, block_w: int, chunk: int) -> Tuple[int, int, int, int, int]:
    if x.dim() != 3:
        raise ValueError(f"rglru_scan: x must be (B, S, W), got {tuple(x.shape)}")
    B, S, W = x.shape
    for name, t in (("r", r), ("i", i)):
        if tuple(t.shape) != (B, S, W):
            raise ValueError(f"rglru_scan: {name} {tuple(t.shape)} does not match x {(B, S, W)}")
    if tuple(lam.shape) != (W,):
        raise ValueError(f"rglru_scan: lam must be ({W},), got {tuple(lam.shape)}")
    for name, t in (("x", x), ("r", r), ("i", i), ("lam", lam)):
        if t.dtype != torch.float32:
            raise ValueError(f"rglru_scan: {name} must be float32, got {t.dtype}")
    if block_w < 1 or chunk < 1:
        raise ValueError(f"rglru_scan: tiles ({block_w},{chunk}) must be >= 1")
    bw, ck = min(block_w, W), min(chunk, S)
    if W % bw or S % ck:
        raise ValueError(f"blocks ({bw},{ck}) must divide (W={W}, S={S})")
    if bw > MAX_THREADS:
        raise ValueError(f"rglru_scan: block_w {bw} is over {MAX_THREADS} threads a CTA")
    if smem_bytes(bw, ck) > SMEM_LIMIT:
        raise ValueError(
            f"rglru_scan: tiles ({bw},{ck}) need {smem_bytes(bw, ck)} B of shared "
            f"memory, over {SMEM_LIMIT} B"
        )
    return B, S, W, bw, ck


def rglru_scan_cuda(
    x: torch.Tensor, r: torch.Tensor, i: torch.Tensor, lam: torch.Tensor,
    block_w: int = 128, chunk: int = 128,
) -> torch.Tensor:
    """Launch the CUDA kernel on contiguous float32 CUDA tensors."""
    B, S, W, bw, ck = _check(x, r, i, lam, block_w, chunk)
    if _build.route((x, r, i, lam), "rglru_scan") != "cuda":
        raise ValueError("rglru_scan_cuda: inputs must be CUDA tensors")
    if not all(t.is_contiguous() for t in (x, r, i, lam)):
        raise ValueError("rglru_scan_cuda: x, r, i, lam must be contiguous")
    y = torch.empty_like(x)
    code = _build.function("rglru_scan", "rglru_scan_launch", _ARGTYPES)(
        x.data_ptr(), r.data_ptr(), i.data_ptr(), lam.data_ptr(), y.data_ptr(),
        B, S, W, bw, ck, _build.stream_of(y),
    )
    _build.check(code, f"rglru_scan_launch(block_w={bw}, chunk={ck})")
    counter.launches += 1
    return y


def rglru_scan(
    x: torch.Tensor, r: torch.Tensor, i: torch.Tensor, lam: torch.Tensor,
    block_w: int = 128, chunk: int = 128,
) -> torch.Tensor:
    """The RG-LRU scan: the CUDA kernel on CUDA tensors, the plain version
    on CPU tensors (tiles are checked either way, so both accept one space)."""
    if _build.route((x, r, i, lam), "rglru_scan") == "cuda":
        return rglru_scan_cuda(x, r, i, lam, block_w, chunk)
    _check(x, r, i, lam, block_w, chunk)
    counter.plain_calls += 1
    return rglru_scan_plain(x, r, i, lam)


def smem_bytes_native(block_w: int, chunk: int) -> int:
    """What the compiled source computes for :func:`smem_bytes` (a check
    that the Python model is the kernel's real footprint)."""
    fn = _build.function("rglru_scan", "rglru_scan_smem_bytes",
                         [ctypes.c_int] * 2, ctypes.c_longlong)
    return int(fn(block_w, chunk))


def traffic(B: int, S: int, W: int) -> Tuple[float, float]:
    """(flops, bytes) of one call: 11 operations a step and channel (exp and
    sqrt counted as one each); x, r and i read once, y written once, lam."""
    return 11.0 * B * S * W, 4.0 * (4.0 * B * S * W + W)
