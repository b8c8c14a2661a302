"""Wrapper of the hand-written CUDA RG-LRU scan kernel (``csrc/rglru_scan.cu``).

``rglru_scan(x, r, i, lam, block_w, chunk, split)`` launches the kernel on
CUDA tensors and runs the plain version (:func:`rglru_scan_plain`, the
module's copy of ``ref.rglru_scan_ref``) on CPU tensors; there is no
fallback from one to the other.  ``counter`` counts both.

x, r and i share one dtype, float32 or bfloat16, and y takes it (as the
JAX kernel casts them to float32 and y to ``x.dtype``); lam is float32.
A CTA holds ``block_w`` channels and ``split`` threads a channel; it walks
the sequence in tiles of ``chunk`` steps, each thread scanning a segment
of ``chunk / split`` of them (rounded up to a compiled length), and joins
the segments with a scan across the channel's threads.  As in the JAX
kernel, each tile is first ``min``'d to its extent; ``block_w`` must then
divide W, while ``chunk`` need not divide S: the kernel sets the steps
past the sequence's end to 0 in shared memory, which makes them the
identity, so every S runs.  ``split``
defaults to the least that keeps a segment at most 32 steps.

``rglru_scan_bwd(x, r, i, lam, dy, block_w, chunk, split)`` is the
backward (``csrc/rglru_scan_bwd.cu`` on CUDA tensors, the plain
:func:`rglru_scan_bwd_plain` on CPU tensors, counted by ``bwd_counter``):
(dx, dr, di, dlam) from the output's gradient dy, on the forward's tiles
and rules.  Every trip of ``chunk`` steps runs in a CTA of its own: a maps
pass writes each trip's forward and adjoint maps to float32 scratch, a
chain pass turns them into each trip's start state and adjoint carry, a
gradient pass reruns each trip from them, and a reduce adds dlam's
partials (:data:`BWD_PHASES`).  It recomputes h in float32, so it never
reads a rounded bf16 output.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _build
from .ref import rglru_scan_bwd_ref, rglru_scan_ref

rglru_scan_plain = rglru_scan_ref
rglru_scan_bwd_plain = rglru_scan_bwd_ref
counter = _build.Counter()
bwd_counter = _build.Counter()

WARP = 32
MAX_THREADS = 512  # threads of one CTA, block_w * split: the kernel's launch bound
MAX_SPLIT = 32     # a channel's threads lie in one warp
SEGMENTS = (4, 8, 16, 32)  # steps a thread scans per tile: compile-time in the kernel
DTYPES = {torch.float32: 4, torch.bfloat16: 2}  # input dtype -> element bytes
SMEM_LIMIT = 232_448  # H100 opt-in shared memory per block

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_BWD_PHASES_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def seg_pad(block_w: int, seg_len: int, split: int, elt: int) -> int:
    """Elements the staged layout skips after each thread's segment of
    ``seg_len`` rows (``seg_pad`` in the source): a segment's stride in
    32-bit words becomes congruent, mod the 32 banks, to the words one
    segment's lanes read in a step, so no two lanes share a bank."""
    if split == 1:
        return 0
    words = max(1, (WARP // split) * elt // 4)
    seg_words = seg_len * block_w * elt // 4
    return (words - seg_words) % 32 * 4 // elt


def seg_len(chunk: int, split: int) -> int:
    """Steps of one thread's segment (``seg_len`` in the source): the least
    compiled length of at least ``ceil(chunk / split)``, or 0 if none is."""
    need = -(-chunk // split)
    return next((L for L in SEGMENTS if need <= L), 0)


def takes_split(chunk: int, split: int) -> bool:
    """Whether the kernel takes ``split`` threads a channel at ``chunk``: a
    power of two up to 32 whose segments of ``ceil(chunk / split)`` steps
    are at most 32, and at least 4 unless one thread holds the channel (a
    shorter one would leave most of the compiled segment idle)."""
    if split < 1 or split > MAX_SPLIT or split & (split - 1):
        return False
    need = -(-chunk // split)
    return need <= SEGMENTS[-1] and (split == 1 or need >= SEGMENTS[0])


def smem_bytes(block_w: int, chunk: int, split: int, elt: int = 4) -> int:
    """Dynamic shared memory of one CTA (``smem_bytes`` in the source): two
    stages of x, r and i tiles, each ``split`` segments of ``seg_len`` rows
    of ``block_w`` elements plus a pad after every segment, 16-byte
    aligned."""
    L = seg_len(chunk, split)
    seg = L * block_w + seg_pad(block_w, L, split, elt)
    return 2 * 3 * (-(-split * seg * elt // 16) * 16)


def default_split(chunk: int) -> int:
    """The least split that keeps a thread's segment at most 32 steps."""
    split = 1
    while -(-chunk // split) > SEGMENTS[-1]:
        split *= 2
    return split


def _check(x, r, i, lam, block_w: int, chunk: int, split: Optional[int]):
    if x.dim() != 3:
        raise ValueError(f"rglru_scan: x must be (B, S, W), got {tuple(x.shape)}")
    B, S, W = x.shape
    for name, t in (("r", r), ("i", i)):
        if tuple(t.shape) != (B, S, W):
            raise ValueError(f"rglru_scan: {name} {tuple(t.shape)} does not match x {(B, S, W)}")
    if tuple(lam.shape) != (W,):
        raise ValueError(f"rglru_scan: lam must be ({W},), got {tuple(lam.shape)}")
    dtypes = {"x": x.dtype, "r": r.dtype, "i": i.dtype}
    if len(set(dtypes.values())) != 1:
        raise ValueError(f"rglru_scan: x, r, i must share one dtype, got mixed {dtypes}")
    if x.dtype not in DTYPES:
        raise ValueError(f"rglru_scan: x, r, i must be float32 or bfloat16, got {x.dtype}")
    if lam.dtype != torch.float32:
        raise ValueError(f"rglru_scan: lam must be float32, got {lam.dtype}")
    if block_w < 1 or chunk < 1:
        raise ValueError(f"rglru_scan: tiles ({block_w},{chunk}) must be >= 1")
    bw, ck = min(block_w, W), min(chunk, S)
    if W % bw:
        raise ValueError(f"blocks ({bw},{ck}): block_w must divide W={W}")
    sp = default_split(ck) if split is None else split
    if not takes_split(ck, sp):
        raise ValueError(
            f"rglru_scan: split {sp} must be a power of two up to {MAX_SPLIT} with "
            f"ceil(chunk / split) in 4..32 (1..32 at split 1), got chunk {ck}"
        )
    threads = bw * sp
    if threads > MAX_THREADS:
        raise ValueError(
            f"rglru_scan: block_w {bw} x split {sp} = {threads} threads; a CTA takes "
            f"up to {MAX_THREADS}"
        )
    elt = DTYPES[x.dtype]
    if smem_bytes(bw, ck, sp, elt) > SMEM_LIMIT:
        raise ValueError(
            f"rglru_scan: tiles ({bw},{ck},{sp}) need {smem_bytes(bw, ck, sp, elt)} B of "
            f"shared memory, over {SMEM_LIMIT} B"
        )
    return B, S, W, bw, ck, sp


def rglru_scan_cuda(
    x: torch.Tensor, r: torch.Tensor, i: torch.Tensor, lam: torch.Tensor,
    block_w: int = 128, chunk: int = 128, split: Optional[int] = None,
) -> torch.Tensor:
    """Launch the CUDA kernel on contiguous CUDA tensors."""
    B, S, W, bw, ck, sp = _check(x, r, i, lam, block_w, chunk, split)
    if _build.route((x, r, i, lam), "rglru_scan") != "cuda":
        raise ValueError("rglru_scan_cuda: inputs must be CUDA tensors")
    if not all(t.is_contiguous() for t in (x, r, i, lam)):
        raise ValueError("rglru_scan_cuda: x, r, i, lam must be contiguous")
    y = torch.empty_like(x)
    code = _build.function("rglru_scan", "rglru_scan_launch", _ARGTYPES)(
        x.data_ptr(), r.data_ptr(), i.data_ptr(), lam.data_ptr(), y.data_ptr(),
        B, S, W, bw, ck, sp, DTYPES[x.dtype], _build.stream_of(y),
    )
    _build.check(code, f"rglru_scan_launch(block_w={bw}, chunk={ck}, split={sp})")
    counter.launched()
    return y


def rglru_scan(
    x: torch.Tensor, r: torch.Tensor, i: torch.Tensor, lam: torch.Tensor,
    block_w: int = 128, chunk: int = 128, split: Optional[int] = None,
) -> torch.Tensor:
    """The RG-LRU scan: the CUDA kernel on CUDA tensors, the plain version
    on CPU tensors (tiles are checked either way, so both accept one space)."""
    if _build.route((x, r, i, lam), "rglru_scan") == "cuda":
        return rglru_scan_cuda(x, r, i, lam, block_w, chunk, split)
    _check(x, r, i, lam, block_w, chunk, split)
    counter.ran_plain()
    return rglru_scan_plain(x, r, i, lam)


def smem_bytes_native(block_w: int, chunk: int, split: int, elt: int = 4) -> int:
    """What the compiled source computes for :func:`smem_bytes` (a check
    that the Python model is the kernel's real footprint)."""
    fn = _build.function("rglru_scan", "rglru_scan_smem_bytes",
                         [ctypes.c_int] * 4, ctypes.c_longlong)
    return int(fn(block_w, chunk, split, elt))


def traffic(B: int, S: int, W: int, elt: int = 4) -> Tuple[float, float]:
    """(flops, bytes) of one call: 11 operations a step and channel (exp and
    sqrt counted as one each); x, r and i read once and y written once at
    ``elt`` bytes an element, lam in float32."""
    return 11.0 * B * S * W, elt * 4.0 * B * S * W + 4.0 * W


COMBINE_STEPS = 3  # a combine of phase B (two shuffles, an FMA) in steps


def chain_steps(S: int, chunk: int, split: int) -> float:
    """Dependent steps on one CTA's chain: each of the ``ceil(S / chunk)``
    tiles' two passes over a thread's segment (``2 S / split`` in all
    where the segments hold the chunk exactly), and its ``log2(split)``
    combines of COMBINE_STEPS steps each."""
    tiles = -(-S // chunk)
    return tiles * (2.0 * seg_len(chunk, split) + (split.bit_length() - 1) * COMBINE_STEPS)


# -- the backward ------------------------------------------------------------


def bwd_max_threads(chunk: int, split: int) -> int:
    """The backward's launch bound at a segment of ``seg_len(chunk,
    split)`` steps (``max_threads`` in the source): 512 threads (128
    registers), 256 at 32 steps, whose a_t and h_{t-1} take 64 registers."""
    return 256 if seg_len(chunk, split) >= SEGMENTS[-1] else MAX_THREADS


def bwd_smem_bytes(block_w: int, chunk: int, split: int, elt: int = 4) -> int:
    """Dynamic shared memory of one backward CTA (``smem_bytes`` in
    ``rglru_scan_bwd.cu``): one trip's x, r, i and dy tiles in the
    forward's layout (whose two stages hold three tiles each)."""
    return smem_bytes(block_w, chunk, split, elt) // 6 * 4


def bwd_trips(S: int, chunk: int) -> int:
    """The trips of ``chunk`` steps that cover S: the backward's CTAs a
    (batch row, channel block)."""
    return -(-S // chunk)


def bwd_scratch_bytes(B: int, S: int, W: int, chunk: int) -> int:
    """Float32 scratch of one backward call: four (B, trips, W) arrays, each
    a whole number of 16 bytes: the trips' products of a_t, their forward
    maps (then start states), their adjoint maps (then carries) and dlam's
    partials."""
    return 4 * 4 * (-(-B * bwd_trips(S, chunk) * W // 4) * 4)


def _bwd_check(x, r, i, lam, dy, block_w: int, chunk: int, split: Optional[int]):
    B, S, W, bw, ck, sp = _check(x, r, i, lam, block_w, chunk, split)
    if bw * sp > bwd_max_threads(ck, sp):
        raise ValueError(f"rglru_scan_bwd: block_w {bw} x split {sp} = {bw * sp} threads; "
                         f"the backward takes up to {bwd_max_threads(ck, sp)} at chunk {ck}")
    if tuple(dy.shape) != (B, S, W) or dy.dtype != x.dtype:
        raise ValueError(f"rglru_scan_bwd: dy must be x's shape {(B, S, W)} and dtype "
                         f"{x.dtype}, got {tuple(dy.shape)} {dy.dtype}")
    elt = DTYPES[x.dtype]
    if bwd_smem_bytes(bw, ck, sp, elt) > SMEM_LIMIT:
        raise ValueError(
            f"rglru_scan_bwd: tiles ({bw},{ck},{sp}) need {bwd_smem_bytes(bw, ck, sp, elt)} B "
            f"of shared memory, over {SMEM_LIMIT} B"
        )
    return B, S, W, bw, ck, sp


BWD_PHASES = {"maps": 1, "chain": 2, "gradients": 4, "reduce": 8}  # the launch's phases mask


def _bwd_launch(x, r, i, lam, dy, tiles: Tuple[int, int, int], phases: Optional[int] = None):
    """Launch the backward on checked CUDA inputs at ``tiles`` = (block_w,
    chunk, split): the whole call (``rglru_scan_bwd_launch``) or the phases
    ``phases`` alone; returns (dx, dr, di, dlam) and ``run(mask)``, which
    launches phases on the same buffers."""
    B, S, W = x.shape
    bw, ck, sp = tiles
    outs = tuple(torch.empty_like(t) for t in (x, r, i, lam))
    scratch = torch.empty(bwd_scratch_bytes(B, S, W, ck) // 4, dtype=torch.float32,
                          device=x.device)
    buffers = (x, r, i, lam, dy, *outs, scratch)  # alive as long as run is
    sizes = (B, S, W, bw, ck, sp, DTYPES[x.dtype])

    def run(mask: Optional[int]) -> None:
        ptrs = [t.data_ptr() for t in buffers]
        if mask is None:
            fn = _build.function("rglru_scan_bwd", "rglru_scan_bwd_launch", _BWD_ARGTYPES)
            code = fn(*ptrs, *sizes, _build.stream_of(outs[0]))
        else:
            fn = _build.function("rglru_scan_bwd", "rglru_scan_bwd_launch_phases",
                                 _BWD_PHASES_ARGTYPES)
            code = fn(*ptrs, *sizes, mask, _build.stream_of(outs[0]))
        _build.check(code, f"rglru_scan_bwd_launch(block_w={bw}, chunk={ck}, split={sp}, "
                           f"phases={mask})")
    run(phases)
    return outs, run


def _bwd_cuda_args(x, r, i, lam, dy, block_w: int, chunk: int, split: Optional[int]):
    B, S, W, bw, ck, sp = _bwd_check(x, r, i, lam, dy, block_w, chunk, split)
    tensors = (x, r, i, lam, dy)
    if _build.route(tensors, "rglru_scan_bwd") != "cuda":
        raise ValueError("rglru_scan_bwd_cuda: inputs must be CUDA tensors")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("rglru_scan_bwd_cuda: x, r, i, lam, dy must be contiguous")
    return bw, ck, sp


def rglru_scan_bwd_cuda(
    x: torch.Tensor, r: torch.Tensor, i: torch.Tensor, lam: torch.Tensor, dy: torch.Tensor,
    block_w: int = 128, chunk: int = 128, split: Optional[int] = None,
):
    """Launch the backward kernel on contiguous CUDA tensors: (dx, dr, di,
    dlam), each in its input's dtype."""
    tiles = _bwd_cuda_args(x, r, i, lam, dy, block_w, chunk, split)
    outs, _ = _bwd_launch(x, r, i, lam, dy, tiles)
    bwd_counter.launched()
    return outs


def bwd_phase_runs(
    x: torch.Tensor, r: torch.Tensor, i: torch.Tensor, lam: torch.Tensor, dy: torch.Tensor,
    block_w: int = 128, chunk: int = 128, split: Optional[int] = None,
) -> dict:
    """The backward's phases one at a time, for timing: runs the whole call
    once (not counted as a launch), then returns {phase name: a function
    launching that phase alone on the call's buffers}."""
    tiles = _bwd_cuda_args(x, r, i, lam, dy, block_w, chunk, split)
    _, run = _bwd_launch(x, r, i, lam, dy, tiles, sum(BWD_PHASES.values()))
    return {name: (lambda bit=bit: run(bit)) for name, bit in BWD_PHASES.items()}


def rglru_scan_bwd(
    x: torch.Tensor, r: torch.Tensor, i: torch.Tensor, lam: torch.Tensor, dy: torch.Tensor,
    block_w: int = 128, chunk: int = 128, split: Optional[int] = None,
):
    """The RG-LRU scan's backward: the CUDA kernel on CUDA tensors, the
    plain version on CPU tensors (tiles are checked either way)."""
    if _build.route((x, r, i, lam, dy), "rglru_scan_bwd") == "cuda":
        return rglru_scan_bwd_cuda(x, r, i, lam, dy, block_w, chunk, split)
    _bwd_check(x, r, i, lam, dy, block_w, chunk, split)
    bwd_counter.ran_plain()
    return rglru_scan_bwd_plain(x, r, i, lam, dy)


def bwd_smem_bytes_native(block_w: int, chunk: int, split: int, elt: int = 4) -> int:
    """What the compiled source computes for :func:`bwd_smem_bytes`."""
    fn = _build.function("rglru_scan_bwd", "rglru_scan_bwd_smem_bytes",
                         [ctypes.c_int] * 4, ctypes.c_longlong)
    return int(fn(block_w, chunk, split, elt))


def bwd_scratch_bytes_native(B: int, S: int, W: int, chunk: int) -> int:
    """What the compiled source computes for :func:`bwd_scratch_bytes`."""
    fn = _build.function("rglru_scan_bwd", "rglru_scan_bwd_scratch_bytes",
                         [ctypes.c_int] * 4, ctypes.c_longlong)
    return int(fn(B, S, W, chunk))


def bwd_max_threads_native(chunk: int, split: int) -> int:
    """What the compiled source takes for :func:`bwd_max_threads`."""
    fn = _build.function("rglru_scan_bwd", "rglru_scan_bwd_max_threads", [ctypes.c_int] * 2)
    return int(fn(chunk, split))


def bwd_traffic(B: int, S: int, W: int, elt: int = 4) -> Tuple[float, float]:
    """(flops, bytes) of one backward call: the forward's 11 operations a
    step and channel again and 20 of the adjoint's (exp, sqrt and rsqrt
    counted as one each); x, r, i and dy read once and dx, dr, di written
    once at ``elt`` bytes an element, lam read and dlam written in
    float32."""
    return 31.0 * B * S * W, elt * 7.0 * B * S * W + 8.0 * W
