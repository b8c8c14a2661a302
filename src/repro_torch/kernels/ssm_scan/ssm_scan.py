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

``ssm_scan_bwd(x, dt, A, Bc, Cc, D, dy, dh, block_d, chunk, seg, channels)``
is the backward (``csrc/ssm_scan_bwd.cu`` on CUDA tensors, the plain
:func:`ssm_scan_bwd_plain` on CPU tensors, counted by ``bwd_counter``):
(dx, ddt, dA, dBc, dCc, dD) from the output's gradient dy and, where the
final state was asked for, its gradient dh.  Its tiles are its own: a CTA
of ``block_d`` channels walks the sequence in trips of ``chunk`` steps, a
thread carries ``seg`` steps of ``channels`` channels through all N
states, and a warp's lanes split into time lanes, one per segment of a
trip, joined by a scan over the lanes, and channel lanes
(:func:`bwd_refusal` says what it takes).  It writes the state at each
trip's start to float32 scratch.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _build
from .ref import ssm_scan_bwd_ref, ssm_scan_ref

ssm_scan_plain = ssm_scan_ref
ssm_scan_bwd_plain = ssm_scan_bwd_ref
counter = _build.Counter()
bwd_counter = _build.Counter()

WARP = 32            # block_d * NP / states is a whole number of warps
N_MAX = 256          # NP / states lanes a channel, at most a warp's 32
STATES = (1, 2, 4, 8, 16)  # states a thread carries: compile-time in the kernel
DTYPES = {torch.float32: 4, torch.bfloat16: 2}  # input dtype -> element bytes
SMEM_LIMIT = 232_448  # H100 opt-in shared memory per block

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 10 + [ctypes.c_void_p]


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


def _check_inputs(x, dt, A, Bc, Cc, D):
    """(B, S, D, N) of inputs of the shapes and dtypes the scans take."""
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
    return Bsz, S, Dd, N


def _check(x, dt, A, Bc, Cc, D, block_d: int, chunk: int, states: int):
    Bsz, S, Dd, N = _check_inputs(x, dt, A, Bc, Cc, D)
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


# -- the backward ------------------------------------------------------------


# (seg, channels, time lanes) the backward kernel compiles (``SSM_BWD_TILES``
# in the source): steps and channels one thread carries, and the lanes of a
# warp over a trip's segments (``chunk`` is seg times the time lanes)
BWD_TILES = ((4, 1, 8), (8, 1, 4), (8, 1, 8), (16, 1, 4), (4, 2, 8), (8, 2, 4))
BWD_BC_AHEAD = 64  # the most states whose B_t, C_t rows the backward fetches a trip ahead
# (seg, time lanes) of sweep 1's kernels: a trip of 64 or 32 steps in
# 16-step segments where D is a multiple of 32, else in 8 time lanes
# (``launch_maps``)
BWD_MAPS_TILES = ((16, 4), (16, 2), (8, 8), (4, 8))


def bwd_max_threads(seg: int, channels: int) -> int:
    """The most threads a backward CTA may have (the kernel's launch
    bound: 128 registers a thread where it holds 4 (step, channel) pairs,
    168 at 8, 255 at 16)."""
    pairs = seg * channels
    return 256 if pairs >= 16 else 384 if pairs >= 8 else 512


def bwd_group(chunk: int, seg: int) -> int:
    """Time lanes of the backward (``lanes_t`` in the source): the lanes of
    a warp that hold one channel's segments of a trip, joined by a scan
    over the lanes; the warp's other ``32 / lanes_t`` lanes are channels."""
    return chunk // seg


def bwd_threads(block_d: int, chunk: int, seg: int, channels: int) -> int:
    """Threads of one backward CTA: a time lane per segment of a trip for
    each ``channels`` channels of the CTA."""
    return block_d // channels * bwd_group(chunk, seg)


def bwd_smem_bytes(block_d: int, chunk: int, n_state: int, seg: int, channels: int,
                   elt: int = 4) -> int:
    """Dynamic shared memory of one sweep-2 CTA of the backward
    (``smem_bytes`` in ``ssm_scan_bwd.cu``), each region a whole number of
    16 bytes: a trip's B_t and C_t in float32 (``n_state`` rows of ``chunk +
    4`` steps each); A log2 e, the trip's start state, the adjoint handed on
    between trips and the CTA's dA sums (``n_state`` by ``block_d`` float32
    each); the warps' dB_t and dC_t sums of a trip (warps, 2, ``n_state``
    rows of ``chunk + 1``); each warp's transpose of a state's dB_t and dC_t
    terms (warps, 2 ``seg``, 32); the next trip's prefetch at ``elt`` bytes
    an element: x, dt and dy rows (``chunk`` rows of ``block_d``), B_t and
    C_t rows (``chunk`` rows of ``n_state``, up to :data:`BWD_BC_AHEAD`
    states; past it they are staged when the trip starts), its start state (``n_state`` by
    ``block_d`` float32); each thread's x of the trip and its dskip terms
    (``seg + 1`` by ``channels`` floats)."""
    def whole(n: int) -> int:
        return -(-n // 4) * 4

    threads = bwd_threads(block_d, chunk, seg, channels)
    warps = threads // WARP
    floats = (2 * whole(n_state * (chunk + 4)) + 4 * whole(n_state * block_d)
              + whole(warps * 2 * n_state * (chunk + 1)) + warps * 2 * seg * WARP
              + 3 * whole(chunk * block_d * elt // 4)
              + 2 * whole(-(-chunk * n_state * elt // 4) if n_state <= BWD_BC_AHEAD else 0)
              + n_state * block_d + threads * (seg + 1) * channels)
    return 4 * floats


def bwd_scratch_bytes(B: int, S: int, D: int, N: int, block_d: int, chunk: int) -> int:
    """Float32 scratch of one backward call (``scratch_bytes`` in the
    source): each trip's map, then the state at the start of every trip but
    the first (B, ceil(S / chunk) - 1, N, D); each trip's sum of dt (B,
    trips - 1, D), read by sweep 1 before sweep 2 writes the CTAs' dB
    partials (B, D / block_d, S, N) in its place; the dC partials; dA's and
    dD's per batch row; each region a whole number of 16 bytes."""
    def whole(n: int) -> int:
        return -(-n // 4) * 4

    trips = -(-S // chunk)
    part = whole(B * (D // block_d) * S * N)
    return 4 * (whole(B * (trips - 1) * N * D) + max(whole(B * (trips - 1) * D), part) + part
                + whole(B * D * N) + whole(B * D))


def bwd_refusal(D: int, block_d: int, chunk: int, seg: int, channels: int) -> Optional[str]:
    """Why the backward kernel does not take these tiles at width D, or
    None where it does (the source's ``ssm_scan_bwd_launch`` checks)."""
    if seg < 1 or chunk % seg or (seg, channels, chunk // seg) not in BWD_TILES:
        return (f"(seg, channels, chunk / seg) ({seg}, {channels}, {chunk / seg:g}) not in "
                f"{BWD_TILES}")
    lanes = bwd_group(chunk, seg)
    if block_d < 1 or D % block_d or block_d % (WARP // lanes * channels):
        return (f"block_d {block_d} must divide D={D} and be a multiple of channels "
                f"{channels} x {WARP // lanes} channel lanes")
    threads = bwd_threads(block_d, chunk, seg, channels)
    if threads > bwd_max_threads(seg, channels):
        return (f"{threads} threads; a CTA of (seg, channels) ({seg}, {channels}) takes up to "
                f"{bwd_max_threads(seg, channels)}")
    return None


def _bwd_check(x, dt, A, Bc, Cc, D, dy, dh, block_d: int, chunk: int, seg: int,
               channels: int):
    Bsz, S, Dd, N = _check_inputs(x, dt, A, Bc, Cc, D)
    if tuple(dy.shape) != (Bsz, S, Dd) or dy.dtype != x.dtype:
        raise ValueError(f"ssm_scan_bwd: dy must be x's shape {(Bsz, S, Dd)} and dtype "
                         f"{x.dtype}, got {tuple(dy.shape)} {dy.dtype}")
    if dh is not None and (tuple(dh.shape) != (Bsz, Dd, N) or dh.dtype != torch.float32):
        raise ValueError(f"ssm_scan_bwd: dh must be float32 {(Bsz, Dd, N)}, got "
                         f"{tuple(dh.shape)} {dh.dtype}")
    refused = bwd_refusal(Dd, block_d, chunk, seg, channels)
    if refused:
        raise ValueError(f"ssm_scan_bwd: {refused}")
    smem = bwd_smem_bytes(block_d, chunk, N, seg, channels, DTYPES[x.dtype])
    if smem > SMEM_LIMIT:
        raise ValueError(f"ssm_scan_bwd: tiles ({block_d},{chunk},{seg},{channels}) need {smem} "
                         f"B of shared memory at N={N}, over {SMEM_LIMIT} B")
    return Bsz, S, Dd, N


BWD_PHASES = {"sweep1": 1, "sweep2": 2, "reduce": 4}  # the launch's phases mask
_ALL_PHASES = sum(BWD_PHASES.values())


def _bwd_launch(args, dh, tiles: Tuple[int, int, int, int], phases: int = _ALL_PHASES):
    """Launch the phases ``phases`` of the backward on checked CUDA inputs
    ``args`` = (x, dt, A, Bc, Cc, D, dy) at ``tiles`` = (block_d, chunk,
    seg, channels); returns the six gradients and ``run(mask)``, which
    launches phases on the same buffers."""
    x, dt, A, Bc, Cc, D, dy = args
    Bsz, S, Dd = x.shape
    N = A.shape[1]
    dx, ddt, dBc, dCc = (torch.empty_like(t) for t in (x, dt, Bc, Cc))
    dA, dD = torch.empty_like(A), torch.empty_like(D)
    scratch = torch.empty(bwd_scratch_bytes(Bsz, S, Dd, N, *tiles[:2]) // 4,
                          dtype=torch.float32, device=x.device)
    outs = (dx, ddt, dA, dBc, dCc, dD)
    launch = _build.function("ssm_scan_bwd", "ssm_scan_bwd_launch", _BWD_ARGTYPES)
    block_d, chunk, seg, channels = tiles

    def run(mask: int) -> None:
        code = launch(*[t.data_ptr() for t in args], None if dh is None else dh.data_ptr(),
                      *[t.data_ptr() for t in outs], scratch.data_ptr(),
                      Bsz, S, Dd, N, block_d, chunk, seg, channels, DTYPES[x.dtype], mask,
                      _build.stream_of(dx))
        _build.check(code, f"ssm_scan_bwd_launch(block_d={block_d}, chunk={chunk}, seg={seg}, "
                           f"channels={channels}, N={N})")
    run(phases)
    return outs, run


def _bwd_cuda_args(x, dt, A, Bc, Cc, D, dy, dh, tiles):
    _bwd_check(x, dt, A, Bc, Cc, D, dy, dh, *tiles)
    tensors = (x, dt, A, Bc, Cc, D, dy) + (() if dh is None else (dh,))
    if _build.route(tensors, "ssm_scan_bwd") != "cuda":
        raise ValueError("ssm_scan_bwd_cuda: inputs must be CUDA tensors")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssm_scan_bwd_cuda: x, dt, A, Bc, Cc, D, dy, dh must be contiguous")
    return (x, dt, A, Bc, Cc, D, dy)


def ssm_scan_bwd_cuda(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bc: torch.Tensor,
    Cc: torch.Tensor, D: torch.Tensor, dy: torch.Tensor, dh: Optional[torch.Tensor] = None,
    block_d: int = 64, chunk: int = 64, seg: int = 8, channels: int = 1,
):
    """Launch the backward kernel on contiguous CUDA tensors: (dx, ddt, dA,
    dBc, dCc, dD), each in its input's dtype."""
    tiles = (block_d, chunk, seg, channels)
    outs, _ = _bwd_launch(_bwd_cuda_args(x, dt, A, Bc, Cc, D, dy, dh, tiles), dh, tiles)
    bwd_counter.launched()
    return outs


def bwd_phase_runs(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bc: torch.Tensor,
    Cc: torch.Tensor, D: torch.Tensor, dy: torch.Tensor, dh: Optional[torch.Tensor] = None,
    block_d: int = 64, chunk: int = 64, seg: int = 8, channels: int = 1,
) -> dict:
    """The backward's phases one at a time, for timing: runs the whole call
    once (not counted as a launch), then returns {phase name: a function
    launching that phase alone on the call's buffers}."""
    tiles = (block_d, chunk, seg, channels)
    _, run = _bwd_launch(_bwd_cuda_args(x, dt, A, Bc, Cc, D, dy, dh, tiles), dh, tiles)
    return {name: (lambda bit=bit: run(bit)) for name, bit in BWD_PHASES.items()}


def ssm_scan_bwd(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bc: torch.Tensor,
    Cc: torch.Tensor, D: torch.Tensor, dy: torch.Tensor, dh: Optional[torch.Tensor] = None,
    block_d: int = 64, chunk: int = 64, seg: int = 8, channels: int = 1,
):
    """The selective scan's backward: the CUDA kernel on CUDA tensors, the
    plain version on CPU tensors (tiles are checked either way)."""
    tensors = (x, dt, A, Bc, Cc, D, dy) + (() if dh is None else (dh,))
    if _build.route(tensors, "ssm_scan_bwd") == "cuda":
        return ssm_scan_bwd_cuda(x, dt, A, Bc, Cc, D, dy, dh, block_d, chunk, seg, channels)
    _bwd_check(x, dt, A, Bc, Cc, D, dy, dh, block_d, chunk, seg, channels)
    bwd_counter.ran_plain()
    return ssm_scan_bwd_plain(x, dt, A, Bc, Cc, D, dy, dh)


def bwd_smem_bytes_native(block_d: int, chunk: int, n_state: int, seg: int,
                          channels: int, elt: int = 4) -> int:
    """What the compiled source computes for :func:`bwd_smem_bytes`."""
    fn = _build.function("ssm_scan_bwd", "ssm_scan_bwd_smem_bytes",
                         [ctypes.c_int] * 6, ctypes.c_longlong)
    return int(fn(block_d, chunk, n_state, seg, channels, elt))


def bwd_scratch_bytes_native(B: int, S: int, D: int, N: int, block_d: int, chunk: int) -> int:
    """What the compiled source computes for :func:`bwd_scratch_bytes`."""
    fn = _build.function("ssm_scan_bwd", "ssm_scan_bwd_scratch_bytes",
                         [ctypes.c_int] * 6, ctypes.c_longlong)
    return int(fn(B, S, D, N, block_d, chunk))


def bwd_max_threads_native(seg: int, channels: int) -> int:
    """What the compiled source takes for :func:`bwd_max_threads`."""
    fn = _build.function("ssm_scan_bwd", "ssm_scan_bwd_max_threads", [ctypes.c_int] * 2)
    return int(fn(seg, channels))


def bwd_traffic(B: int, S: int, D: int, N: int, elt: int = 4) -> Tuple[float, float]:
    """(flops, bytes) of one backward call: the forward's 7 operations a
    step and state again, and 12 of the adjoint's (the exp counted as one),
    and 8 a step and channel; x, dt, dy, Bc, Cc and dh read once, dx, ddt,
    dBc, dCc written once at ``elt`` bytes an element (dh float32), A and D
    read and dA and dD written in float32."""
    flops = 19.0 * B * S * D * N + 8.0 * B * S * D
    bytes_ = (elt * (5.0 * B * S * D + 4.0 * B * S * N) + 4.0 * B * D * N
              + 8.0 * (D * N + D))
    return flops, bytes_
