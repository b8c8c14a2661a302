"""Wrapper of the hand-written CUDA selective-scan kernel (``csrc/ssm_scan.cu``).

``ssm_scan(x, dt, A, Bc, Cc, D, block_d, chunk, states)`` launches the
kernel on CUDA tensors and runs the plain version (:func:`ssm_scan_plain`,
the module's copy of ``ref.ssm_scan_ref``) on CPU tensors; there is no
fallback from one to the other.  ``counter`` counts both.  The positional
order is the JAX package's; ``D`` is the skip vector, not the width.

x, dt, Bc and Cc share one dtype, float32 or bfloat16, and y takes it (as
the JAX kernel casts them to float32 and y to ``x.dtype``); A and D are
float32.  The kernel runs on NP states, N rounded up to a power of two
(:func:`pad_states`; the states past N read A = 0 and B = C = 0 in shared
memory, so they stay 0 and add nothing), and N may be anything from 1 to
:data:`N_MAX`.  One thread carries ``states`` consecutive states of a
channel over the whole sequence, so a channel takes ``NP / states``
threads, at most a warp, and a CTA of ``block_d`` channels
``block_d * NP / states``; it stages ``chunk`` time steps per loop trip in
one of two shared-memory stages.  As in the JAX kernel, each tile is first
``min``'d to its extent (``states`` to NP); ``block_d`` must then divide D,
while ``chunk`` need not divide S: the kernel sets the steps past the
sequence's end to dt = 0 (decay 1, input 0) in shared memory, so every S
runs.  With ``final_state=True`` the call also returns the state after the
last step, (B, D, N) float32, which the kernel writes where it keeps it
(a model's prefill hands it to decode).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import _build
from .ref import ssm_scan_ref

ssm_scan_plain = ssm_scan_ref
counter = _build.Counter()

WARP = 32            # block_d * NP / states is a whole number of warps
N_MAX = 256          # NP / states lanes a channel, at most a warp's 32
STATES = (1, 2, 4, 8, 16)  # states a thread carries: compile-time in the kernel
DTYPES = {torch.float32: 4, torch.bfloat16: 2}  # input dtype -> element bytes
SMEM_LIMIT = 232_448  # H100 opt-in shared memory per block

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def max_threads(states: int) -> int:
    """The most threads a CTA may have at ``states`` states a thread (the
    kernel's launch bound: 128 registers a thread, 255 at 8 and 16)."""
    return 256 if states >= 8 else 512


def group(states: int) -> int:
    """Steps the kernel takes together (``U``): their decays first, then the
    recurrence, then one reduce-scatter of their y sums; ``chunk`` is a
    multiple of it unless it is the whole sequence (a shorter group costs
    a whole one)."""
    return 32 // states


def pad_states(n_state: int) -> int:
    """The states the kernel runs on: ``n_state`` rounded up to a power
    of two."""
    return 1 << (n_state - 1).bit_length()


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def smem_bytes(block_d: int, chunk: int, n_state: int, elt: int = 4) -> int:
    """Dynamic shared memory of one CTA (``smem_bytes`` in the source):
    two stages, each ``chunk`` steps rounded up to 32 (a whole group at any
    ``states``) of x and dt for ``block_d`` channels and of B_t, C_t in
    rows of :func:`pad_states` values, at ``elt`` bytes an element, each
    array 16-byte aligned."""
    rows = -(-chunk // WARP) * WARP
    stage = (2 * _align16(rows * block_d * elt)
             + 2 * _align16(rows * pad_states(n_state) * elt))
    return 2 * stage


def _check(x, dt, A, Bc, Cc, D, block_d: int, chunk: int, states: int):
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
    dtypes = {name: t.dtype for name, t in (("x", x), ("dt", dt), ("Bc", Bc), ("Cc", Cc))}
    if len(set(dtypes.values())) != 1:
        raise ValueError(f"ssm_scan: x, dt, Bc, Cc must share one dtype, got mixed {dtypes}")
    if x.dtype not in DTYPES:
        raise ValueError(f"ssm_scan: x, dt, Bc, Cc must be float32 or bfloat16, got {x.dtype}")
    for name, t in (("A", A), ("D", D)):
        if t.dtype != torch.float32:
            raise ValueError(f"ssm_scan: {name} must be float32, got {t.dtype}")
    if not 1 <= N <= N_MAX:
        raise ValueError(f"ssm_scan: state size N={N} outside 1..{N_MAX} (the kernel's "
                         f"{N_MAX} states a channel: {WARP} lanes of up to 8 each)")
    if block_d < 1 or chunk < 1:
        raise ValueError(f"ssm_scan: tiles ({block_d},{chunk}) must be >= 1")
    NP = pad_states(N)
    bd, ck, k = min(block_d, Dd), min(chunk, S), min(states, NP)
    if Dd % bd:
        raise ValueError(f"blocks ({bd},{ck}): block_d must divide D={Dd}")
    if k not in STATES:
        raise ValueError(f"ssm_scan: states {states} not in {STATES}")
    if NP // k > WARP:
        raise ValueError(f"ssm_scan: states {k} leave {NP // k} lanes a channel at N={N} "
                         f"({NP} run); a channel takes at most {WARP}")
    if ck % group(k) and ck != S:
        raise ValueError(
            f"ssm_scan: chunk {ck} is not a multiple of the {group(k)} steps taken together "
            f"at states {k}, nor the whole sequence S={S}"
        )
    threads = bd * NP // k
    if threads > max_threads(k) or threads % WARP:
        raise ValueError(
            f"ssm_scan: block_d {bd} x N {NP} / states {k} = {threads} threads; a CTA "
            f"takes a multiple of {WARP} up to {max_threads(k)}"
        )
    elt = DTYPES[x.dtype]
    if smem_bytes(bd, ck, N, elt) > SMEM_LIMIT:
        raise ValueError(
            f"ssm_scan: tiles ({bd},{ck}) need {smem_bytes(bd, ck, N, elt)} B of shared "
            f"memory, over {SMEM_LIMIT} B"
        )
    return Bsz, S, Dd, N, bd, ck, k


def ssm_scan_cuda(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bc: torch.Tensor,
    Cc: torch.Tensor, D: torch.Tensor, block_d: int = 32, chunk: int = 128,
    states: int = 1, final_state: bool = False,
):
    """Launch the CUDA kernel on contiguous CUDA tensors; with
    ``final_state``, ``(y, h)`` with h the state after the last step,
    (B, D, N) float32."""
    Bsz, S, Dd, N, bd, ck, k = _check(x, dt, A, Bc, Cc, D, block_d, chunk, states)
    tensors = (x, dt, A, Bc, Cc, D)
    if _build.route(tensors, "ssm_scan") != "cuda":
        raise ValueError("ssm_scan_cuda: inputs must be CUDA tensors")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssm_scan_cuda: x, dt, A, Bc, Cc, D must be contiguous")
    y = torch.empty_like(x)
    h = torch.empty((Bsz, Dd, N), dtype=torch.float32, device=x.device) if final_state else None
    code = _build.function("ssm_scan", "ssm_scan_launch", _ARGTYPES)(
        *[t.data_ptr() for t in tensors], y.data_ptr(), None if h is None else h.data_ptr(),
        Bsz, S, Dd, N, bd, ck, k, DTYPES[x.dtype], _build.stream_of(y),
    )
    _build.check(code, f"ssm_scan_launch(block_d={bd}, chunk={ck}, states={k}, N={N})")
    counter.launched()
    return (y, h) if final_state else y


def ssm_scan(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bc: torch.Tensor,
    Cc: torch.Tensor, D: torch.Tensor, block_d: int = 32, chunk: int = 128,
    states: int = 1, final_state: bool = False,
):
    """The selective scan: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors (tiles are checked either way, so both accept
    one space); ``final_state`` as in :func:`ssm_scan_cuda`."""
    if _build.route((x, dt, A, Bc, Cc, D), "ssm_scan") == "cuda":
        return ssm_scan_cuda(x, dt, A, Bc, Cc, D, block_d, chunk, states, final_state)
    _check(x, dt, A, Bc, Cc, D, block_d, chunk, states)
    counter.ran_plain()
    return ssm_scan_plain(x, dt, A, Bc, Cc, D, final_state=final_state)


def smem_bytes_native(block_d: int, chunk: int, n_state: int, elt: int = 4) -> int:
    """What the compiled source computes for :func:`smem_bytes` (a check
    that the Python model is the kernel's real footprint)."""
    fn = _build.function("ssm_scan", "ssm_scan_smem_bytes",
                         [ctypes.c_int] * 4, ctypes.c_longlong)
    return int(fn(block_d, chunk, n_state, elt))


def max_threads_native(states: int) -> int:
    """What the compiled source takes for :func:`max_threads`."""
    return int(_build.function("ssm_scan", "ssm_scan_max_threads", [ctypes.c_int])(states))


def traffic(B: int, S: int, D: int, N: int, elt: int = 4) -> Tuple[float, float]:
    """(flops, bytes) of one call: 7 operations a step and state (the exp
    counted as one) and 3 a step and channel; x, dt, Bc, Cc read once and
    y written once at ``elt`` bytes an element, A and D in float32."""
    flops = 7.0 * B * S * D * N + 3.0 * B * S * D
    bytes_ = elt * (3.0 * B * S * D + 2.0 * B * S * N) + 4.0 * (D * N + D)
    return flops, bytes_


def sfu_seconds(B: int, S: int, D: int, N: int, peak_flops_fp32: float) -> float:
    """Least time of the call's exps: one MUFU.EX2 per (t, d, n), at the
    SFU's 16 a clock per SM, which is ``peak_flops_fp32 / 16`` (an SM's
    128 float32 lanes do 2 operations a clock each)."""
    return B * S * D * N / (peak_flops_fp32 / 16.0)
