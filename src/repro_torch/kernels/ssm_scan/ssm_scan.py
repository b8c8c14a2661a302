"""Wrapper of the hand-written CUDA selective-scan kernel (``csrc/ssm_scan.cu``).

``ssm_scan(x, dt, A, Bc, Cc, D, block_d, chunk)`` launches the kernel on
CUDA tensors and runs the plain version (:func:`ssm_scan_plain`, the
module's copy of ``ref.ssm_scan_ref``) on CPU tensors; there is no fallback
from one to the other.  ``counter`` counts both.  The positional order is
the JAX package's; ``D`` is the skip vector, not the width.

One thread per (channel, state) pair carries h over the whole sequence; a
CTA holds ``block_d`` channels (``block_d * N`` threads) and stages
``chunk`` time steps per loop trip in shared memory.  As in the JAX
kernel, each tile is first ``min``'d to its extent and must then divide
it.  The kernel takes float32 and an N that is a power of two up to 32.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import _build
from .ref import ssm_scan_ref

ssm_scan_plain = ssm_scan_ref
counter = _build.Counter()

MAX_THREADS = 1024   # threads of one CTA: block_d * N
WARP = 32            # block_d * N is a whole number of warps
N_STATES = (1, 2, 4, 8, 16, 32)
SMEM_LIMIT = 232_448  # H100 opt-in shared memory per block

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def smem_bytes(block_d: int, chunk: int, n_state: int) -> int:
    """Dynamic shared memory of one CTA (``smem_bytes`` in the source):
    ``chunk`` steps of x, dt and y for ``block_d`` channels and of B_t, C_t."""
    return 4 * chunk * (3 * block_d + 2 * n_state)


def _check(x, dt, A, Bc, Cc, D, block_d: int, chunk: int):
    if x.dim() != 3 or A.dim() != 2:
        raise ValueError(
            f"ssm_scan: x must be (B, S, D) and A (D, N), got {tuple(x.shape)}, "
            f"{tuple(A.shape)}"
        )
    Bsz, S, Dd = x.shape
    N = A.shape[1]
    expected = {"dt": (Bsz, S, Dd), "A": (Dd, N), "Bc": (Bsz, S, N),
                "Cc": (Bsz, S, N), "D": (Dd,)}
    for name, t in (("dt", dt), ("A", A), ("Bc", Bc), ("Cc", Cc), ("D", D)):
        if tuple(t.shape) != expected[name]:
            raise ValueError(
                f"ssm_scan: {name} must be {expected[name]}, got {tuple(t.shape)}"
            )
    for name, t in (("x", x), ("dt", dt), ("A", A), ("Bc", Bc), ("Cc", Cc), ("D", D)):
        if t.dtype != torch.float32:
            raise ValueError(f"ssm_scan: {name} must be float32, got {t.dtype}")
    if N not in N_STATES:
        raise ValueError(f"ssm_scan: state size N={N} not in {N_STATES}")
    if block_d < 1 or chunk < 1:
        raise ValueError(f"ssm_scan: tiles ({block_d},{chunk}) must be >= 1")
    bd, ck = min(block_d, Dd), min(chunk, S)
    if Dd % bd or S % ck:
        raise ValueError(f"blocks ({bd},{ck}) must divide (D={Dd}, S={S})")
    threads = bd * N
    if threads > MAX_THREADS or threads % WARP:
        raise ValueError(
            f"ssm_scan: block_d {bd} x N {N} = {threads} threads; a CTA takes "
            f"a multiple of {WARP} up to {MAX_THREADS}"
        )
    if smem_bytes(bd, ck, N) > SMEM_LIMIT:
        raise ValueError(
            f"ssm_scan: tiles ({bd},{ck}) need {smem_bytes(bd, ck, N)} B of shared "
            f"memory, over {SMEM_LIMIT} B"
        )
    return Bsz, S, Dd, N, bd, ck


def ssm_scan_cuda(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bc: torch.Tensor,
    Cc: torch.Tensor, D: torch.Tensor, block_d: int = 32, chunk: int = 128,
) -> torch.Tensor:
    """Launch the CUDA kernel on contiguous float32 CUDA tensors."""
    Bsz, S, Dd, N, bd, ck = _check(x, dt, A, Bc, Cc, D, block_d, chunk)
    tensors = (x, dt, A, Bc, Cc, D)
    if _build.route(tensors, "ssm_scan") != "cuda":
        raise ValueError("ssm_scan_cuda: inputs must be CUDA tensors")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssm_scan_cuda: x, dt, A, Bc, Cc, D must be contiguous")
    y = torch.empty_like(x)
    code = _build.function("ssm_scan", "ssm_scan_launch", _ARGTYPES)(
        *[t.data_ptr() for t in tensors], y.data_ptr(),
        Bsz, S, Dd, N, bd, ck, _build.stream_of(y),
    )
    _build.check(code, f"ssm_scan_launch(block_d={bd}, chunk={ck}, N={N})")
    counter.launches += 1
    return y


def ssm_scan(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bc: torch.Tensor,
    Cc: torch.Tensor, D: torch.Tensor, block_d: int = 32, chunk: int = 128,
) -> torch.Tensor:
    """The selective scan: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors (tiles are checked either way, so both accept
    one space)."""
    if _build.route((x, dt, A, Bc, Cc, D), "ssm_scan") == "cuda":
        return ssm_scan_cuda(x, dt, A, Bc, Cc, D, block_d, chunk)
    _check(x, dt, A, Bc, Cc, D, block_d, chunk)
    counter.plain_calls += 1
    return ssm_scan_plain(x, dt, A, Bc, Cc, D)


def smem_bytes_native(block_d: int, chunk: int, n_state: int) -> int:
    """What the compiled source computes for :func:`smem_bytes` (a check
    that the Python model is the kernel's real footprint)."""
    fn = _build.function("ssm_scan", "ssm_scan_smem_bytes",
                         [ctypes.c_int] * 3, ctypes.c_longlong)
    return int(fn(block_d, chunk, n_state))


def traffic(B: int, S: int, D: int, N: int) -> Tuple[float, float]:
    """(flops, bytes) of one call: 7 operations a step and state (the exp
    counted as one) and 3 a step and channel; x, dt, Bc, Cc read once, y
    written once, A and D."""
    flops = 7.0 * B * S * D * N + 3.0 * B * S * D
    bytes_ = 4.0 * (3.0 * B * S * D + 2.0 * B * S * N + D * N + D)
    return flops, bytes_
