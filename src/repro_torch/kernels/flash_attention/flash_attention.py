"""Wrappers of the hand-written CUDA flash attention kernels.

``flash_attention(q, k, v, block_q, block_kv)`` launches a kernel on CUDA
tensors and runs the plain version (:func:`attention_plain`, the module's
copy of ``ref.attention_ref``) on CPU tensors; there is no fallback from
one to the other.  ``counter`` counts both.  ``return_lse=True`` also
returns the rows' log-sum-exp (float32 (B, H, S)), the residual of
:func:`flash_attention_bwd`: dq, dk, dv from (q, k, v, o, lse, do), a
kernel on CUDA tensors and :func:`attention_bwd_plain` on CPU tensors,
counted by ``bwd_counter``.  The backward's bf16 calls, at every head dim,
run on ``csrc/flash_attention_bwd_sm90.cu`` (wgmma and a TMA ring,
:data:`BWD_SM90_TILES`), its float32 calls on
``csrc/flash_attention_bwd.cuh`` (``mma.sync`` in 3xTF32,
:data:`BWD_F32_TILES`); both take the tunable ``kv_split`` of the GQA
group.

Two kernels, by dtype, both one CTA per (q block, head, batch) with
``block_kv`` a loop inside the CTA, both masking a sequence the tiles do
not divide instead of padding it in memory:

* bfloat16: ``csrc/flash_attention_sm90.cu``, wgmma on the tensor cores
  with TMA loads into a 2-stage ring.  Its tiles are compile-time: only
  the (tile hd, block_q, block_kv) in :data:`SM90_TILES` launch.
* float32: ``csrc/flash_attention.cu``, ``mma.sync`` on the tensor cores
  in 3xTF32 (each product split into a TF32 high part and the rest, three
  TF32 products, so float32 accuracy holds) with ``cp.async`` loads into a
  2-stage ring.  Its tiles are compile-time too: :data:`F32_TILES`.

The head dim is a run-time value in both: a call runs on the least tile
head dim in :data:`TILE_HEAD_DIMS` at or above its ``hd`` (:func:`tile_hd`),
and the tile's columns past ``hd`` load as zeros inside the kernel.  The
kernels load rows of whole 16-byte pieces: ``hd`` a multiple of 8 in bf16
(TMA's stride rule), of 4 in float32 (the cp.async pieces).  The wrapper
takes every ``hd`` from 1 to 256 all the same: one off that rule is copied
into q, k, v of :func:`padded_hd` columns (the new ones zero, which add
nothing to a score or an output column the caller keeps), the kernel runs
at the padded ``hd`` with the scale of the true one, and the first ``hd``
columns of its output are returned.  A TMA box or a cp.async ring of
narrower pieces would take such rows in place; the copy is O(S·heads·hd)
bytes against the kernel's O(S²) work and leaves the kernels as they are.
:func:`launchable` is the one predicate the emit layer and the wrapper
share.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .. import _build
from .ref import attention_bwd_plain, attention_ref

attention_plain = attention_ref
counter = _build.Counter()
bwd_counter = _build.Counter()

TILE_HEAD_DIMS = (16, 32, 64, 128, 256)
HD_MAX = 256
# the kernels' hd a multiple of this: rows of whole 16-byte pieces (the
# wrapper pads any other hd up to it)
HD_MULTIPLE = {"bfloat16": 8, "float32": 4}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int,
                                                 ctypes.c_void_p]
)
_SM90_ARGTYPES = (
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int,
                                                 ctypes.c_void_p]
)
_BWD_F32_LIB = "flash_attention_bwd_f32"
_BWD_F32_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
                     + [ctypes.c_float, ctypes.c_void_p])
_BWD_SM90_LIB = "flash_attention_bwd_sm90"
_BWD_SM90_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
                      + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
# the passes of one sm90 backward launch, a bit each (kPass* in the source)
BWD_PASSES = {"delta": 1, "dq": 2, "dkv": 4, "reduce": 8}
_ALL_PASSES = sum(BWD_PASSES.values())

# The bf16 kernel's instantiations (FLASH_SM90_TILES in the source): a
# warpgroup owns 64 query rows, so block_q is 64 or 128; block_kv is the n
# of the S = Q.K^T wgmma, at most 128 at hd 128, where S, O and P of 64 rows
# would not fit 255 registers otherwise.
SM90_BLOCK_Q = (64, 128)
SM90_BLOCK_KV = (32, 64, 128, 256)


def sm90_max_block_kv(tile: int) -> int:
    """The largest block_kv at tile head dim ``tile`` (registers: O alone
    is 128 a thread at 256)."""
    return {128: 128, 256: 64}.get(tile, 256)


SM90_TILES = frozenset(
    (t, bq, bkv) for t in TILE_HEAD_DIMS for bq in SM90_BLOCK_Q for bkv in SM90_BLOCK_KV
    if bkv <= sm90_max_block_kv(t)
)

# The float32 kernel's instantiations (FLASH_F32_TILES in the source): a
# warp owns 16 query rows, so block_q is 16 x its warps; block_kv is the
# keys of one ring stage, at most 64 at hd 128, where two stages of 128
# keys would not fit the shared memory, and one tile, (64, 32), at hd 256.
F32_BLOCK_Q = (64, 128)
F32_BLOCK_KV = (32, 64, 128)


def f32_max_block_kv(tile: int) -> int:
    return {128: 64, 256: 32}.get(tile, 128)


def f32_max_block_q(tile: int) -> int:
    return 64 if tile == 256 else 128


F32_TILES = frozenset(
    (t, bq, bkv) for t in TILE_HEAD_DIMS for bq in F32_BLOCK_Q for bkv in F32_BLOCK_KV
    if bkv <= f32_max_block_kv(t) and bq <= f32_max_block_q(t)
)


# The backward kernels' instantiations.  bf16, the wgmma kernel
# (FLASH_BWD_SM90_TILES in csrc/flash_attention_bwd_sm90.cu): block_q is the
# dq pass's rows and block_kv the dk/dv pass's keys, a warpgroup per 64 of
# each, so each is 64 or 128; block_q 64 at tile hd 128, where the dk/dv
# pass's S^T, dP^T, dK and dV of 128 rows would be 256 floats a thread; one
# tile at hd 256, where two warpgroups share the dk/dv pass's 64 keys.
BWD_SM90_TILES = frozenset(
    [(t, bq, bkv) for t in (16, 32, 64) for bq in (64, 128) for bkv in (64, 128)]
    + [(128, 64, bkv) for bkv in (64, 128)] + [(256, 64, 64)]
)
# float32, the mma.sync kernel (FLASH_BWD_TILES_F32 in
# csrc/flash_attention_bwd.cuh): block_q is the dq pass's rows and the dk/dv
# pass's streamed q block, block_kv the other way round, each 32 or 64
# (block_kv 32 at hd 256); tile hd 16 and 32 take the two square tiles.
BWD_F32_TILES = frozenset(
    [(t, b, b) for t in (16, 32) for b in (32, 64)]
    + [(t, bq, bkv) for t in (64, 128) for bq in (32, 64) for bkv in (32, 64)]
    + [(256, bq, 32) for bq in (32, 64)]
)
BWD_TILES = {"float32": BWD_F32_TILES, "bfloat16": BWD_SM90_TILES}
# a block's opt-in shared memory on sm_90 (227 KB): the float32 backward's
# passes take a second ring stage where it fits (kSmemMax in the source)
BWD_SMEM_MAX = 232448


def bwd_sm90(dtype: str) -> bool:
    """True iff the backward of ``dtype`` runs on the wgmma kernel (bf16, at
    every head dim); float32 runs on the mma.sync kernel."""
    return dtype == "bfloat16"


def bwd_blocks(tile: int, dtype: str) -> tuple:
    """The (block_q, block_kv) sizes the backward's instantiations at tile
    head dim ``tile`` take, least first."""
    tiles = [t for t in BWD_TILES[dtype] if t[0] == tile]
    return (tuple(sorted({t[1] for t in tiles})), tuple(sorted({t[2] for t in tiles})))


def head_dim_error(hd: int, dtype: str) -> Optional[str]:
    """Why the wrapper of ``dtype`` (``"float32"``/``"bfloat16"``) does
    not take head dim ``hd``, or None where it does."""
    if dtype not in HD_MULTIPLE:
        return f"flash_attention: dtype {dtype} not supported"
    if hd < 1 or hd > HD_MAX:
        return f"flash_attention: {dtype} head_dim {hd} must be from 1 up to {HD_MAX}"
    return None


def padded_hd(hd: int, dtype: str) -> int:
    """The head dim the kernel of ``dtype`` runs a call at ``hd`` on:
    ``hd`` rounded up to the kernel's multiple (rows of whole 16-byte
    pieces)."""
    m = HD_MULTIPLE[dtype]
    return -(-hd // m) * m


def tile_hd(hd: int, dtype: str) -> Optional[int]:
    """The tile head dim a call at ``hd`` runs on (the least of
    :data:`TILE_HEAD_DIMS` at or above it), or None where the wrapper does
    not take ``hd``."""
    if head_dim_error(hd, dtype) is not None:
        return None
    return next(t for t in TILE_HEAD_DIMS if t >= hd)


def pad_head_dim(t: torch.Tensor, hd_pad: int) -> torch.Tensor:
    """``t`` (..., hd) copied into a contiguous tensor of ``hd_pad``
    columns, the new ones zero."""
    out = t.new_zeros(t.shape[:-1] + (hd_pad,))
    out[..., :t.shape[-1]] = t
    return out


def launchable(hd: int, dtype: str, block_q: int, block_kv: int) -> bool:
    """True iff the kernel of ``dtype`` launches (block_q, block_kv) at
    head dim ``hd``: the emit layer's point filter and the wrapper's check."""
    tile = tile_hd(hd, dtype)
    tiles = SM90_TILES if dtype == "bfloat16" else F32_TILES
    return tile is not None and (tile, block_q, block_kv) in tiles


def bwd_launchable(hd: int, dtype: str, block_q: int, block_kv: int, kv_split: int = 1,
                   group: int = 1) -> bool:
    """True iff the backward kernel of ``dtype`` launches (block_q,
    block_kv, kv_split) at head dim ``hd`` with ``group`` query heads a KV
    head: the emit layer's point filter and the wrapper's check.  A
    ``kv_split`` is any divisor of ``group``, in either kernel."""
    tile = tile_hd(hd, dtype)
    if tile is None or (tile, block_q, block_kv) not in BWD_TILES.get(dtype, ()):
        return False
    return kv_split >= 1 and group % kv_split == 0


def bwd_smem_bytes(block_q: int, block_kv: int, hd: int, elt: int) -> int:
    """Dynamic shared memory of the backward's larger pass at the tile head
    dim ``hd`` runs on.  The wgmma kernel (bf16, ``Tile::kSmem``): 1 KiB to
    align the swizzled tiles and 64 bytes of barriers; the dq pass's q and do
    tiles and two stages of k and v, the dk/dv pass's k and v tiles and two
    stages of q, do and the q block's lse and delta, and at tile hd 256 the
    staged bf16 P^T and dS^T (block_kv x block_q each).  The float32
    mma.sync kernel (``DqTile`` and ``DkvTile::kSmem``): rows of hd + 4
    floats; the dq pass's q and do tiles and staged dS (rows of block_kv + 8)
    and a ring of k and v, the dk/dv pass's k and v tiles and staged P^T and
    dS^T (rows of block_q + 8) and a ring of q, do, lse and delta; two
    stages where they fit :data:`BWD_SMEM_MAX`, else one."""
    t = max(16, 1 << (hd - 1).bit_length())
    if elt == 2:
        dq = 1024 + 4 * t * block_q + 8 * t * block_kv + 64
        staged = 4 * block_kv * block_q if t == 256 else 0
        dkv = 1024 + 4 * t * block_kv + 8 * t * block_q + 16 * block_q + staged + 64
        return max(dq, dkv)
    ld = t + 4
    passes = ((4 * (2 * block_q * ld + block_q * (block_kv + 8)), 4 * 2 * block_kv * ld),
              (4 * (2 * block_kv * ld + 2 * block_kv * (block_q + 8)),
               4 * (2 * block_q * ld + 2 * block_q)))
    return max(fixed + (2 if fixed + 2 * stage <= BWD_SMEM_MAX else 1) * stage
               for fixed, stage in passes)


def bwd_scratch_bytes(B: int, S: int, KV: int, hd: int, kv_split: int) -> int:
    """Bytes of the float32 partials of dk and dv a backward call at
    ``kv_split`` writes and its reduce pass sums (0 at 1): two of
    (kv_split, B, S, KV, hd) at the head dim the kernel runs."""
    return 0 if kv_split == 1 else 2 * kv_split * B * S * KV * hd * 4


def smem_bytes(block_q: int, block_kv: int, hd: int, elt: int) -> int:
    """Dynamic shared memory of one CTA (``Tile::kSmem`` in the sources)
    at the tile head dim ``hd`` runs on (the power of two at or above it,
    16 at least).  float32: the q tile and two stages of a k tile (rows
    padded by 8 floats) and a v tile (rows padded by 4).  bf16: 1 KiB to
    align the swizzled tiles, the q tile, two stages of k and v tiles, and
    64 bytes of barriers."""
    t = max(16, 1 << (hd - 1).bit_length())
    if elt == 2:
        return 1024 + 2 * t * (block_q + 4 * block_kv) + 64
    return 4 * (block_q * (t + 8) + 2 * block_kv * ((t + 8) + (t + 4)))


def _check(q, k, v, block_q: int, block_kv: int):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be (B, S, heads, hd)")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if tuple(k.shape) != (B, S, KV, hd) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(
            f"flash_attention: k/v {tuple(k.shape)}/{tuple(v.shape)} do not "
            f"match q {tuple(q.shape)}"
        )
    if KV < 1 or H % KV:
        raise ValueError(f"flash_attention: {H} query heads over {KV} KV heads")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("flash_attention: q, k, v must share one dtype")
    if block_q < 1 or block_kv < 1:
        raise ValueError(f"flash_attention: tiles ({block_q},{block_kv}) must be >= 1")
    return B, S, H, KV, hd


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    block_q: int = 64, block_kv: int = 64, causal: bool = True, return_lse: bool = False,
):
    """Launch the CUDA kernel on contiguous CUDA tensors (f32 or bf16);
    with ``return_lse``, (o, lse)."""
    B, S, H, KV, hd = _check(q, k, v, block_q, block_kv)
    if _build.route((q, k, v), "flash_attention") != "cuda":
        raise ValueError("flash_attention_cuda: inputs must be CUDA tensors")
    dtype = _name(q.dtype)
    why = head_dim_error(hd, dtype)
    if why is not None:
        raise ValueError(why)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_cuda: q, k, v must be contiguous")
    if not launchable(hd, dtype, block_q, block_kv):
        raise ValueError(
            f"flash_attention_cuda: {dtype} tile (hd={tile_hd(hd, dtype)}, {block_q}, "
            f"{block_kv}) is not instantiated"
        )
    smem = smem_bytes(block_q, block_kv, hd, q.element_size())
    limit = smem_optin(q.device)
    if smem > limit:
        raise ValueError(
            f"flash_attention_cuda: tiles ({block_q},{block_kv}) need {smem} B "
            f"of shared memory, the card allows {limit} B"
        )
    scale = 1.0 / math.sqrt(hd)  # the true hd's, whatever the kernel runs on
    hd_run = padded_hd(hd, dtype)
    if hd_run != hd:
        q, k, v = (pad_head_dim(t, hd_run) for t in (q, k, v))
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention_cuda: the 16-byte loads need 16-byte aligned "
                         "q, k, v")
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) if return_lse else None
    lse_ptr = lse.data_ptr() if return_lse else None
    if q.dtype == torch.bfloat16:
        what = "flash_attention_sm90_launch"
        code = _build.function("flash_attention_sm90", what, _SM90_ARGTYPES)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse_ptr,
            B, S, H, KV, hd_run, block_q, block_kv, scale, int(causal), _build.stream_of(o),
        )
    else:
        what = "flash_attention_launch"
        code = _build.function("flash_attention", what, _ARGTYPES)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse_ptr, _DTYPES[q.dtype],
            B, S, H, KV, hd_run, block_q, block_kv, scale, int(causal), _build.stream_of(o),
        )
    _build.check(code, f"{what}(block_q={block_q}, block_kv={block_kv})")
    counter.launched()
    o = o if hd_run == hd else o[..., :hd].contiguous()
    return (o, lse) if return_lse else o


def _bwd_inputs(q, k, v, o, lse, do, block_q: int, block_kv: int, kv_split: int):
    """The wrapper's checks of a backward call on CUDA tensors; returns
    (B, S, H, KV, hd, dtype name)."""
    B, S, H, KV, hd = _check(q, k, v, block_q, block_kv)
    if _build.route((q, k, v, o, lse, do), "flash_attention_bwd") != "cuda":
        raise ValueError("flash_attention_bwd_cuda: inputs must be CUDA tensors")
    dtype = _name(q.dtype)
    why = head_dim_error(hd, dtype)
    if why is not None:
        raise ValueError(why)
    if tuple(o.shape) != tuple(q.shape) or tuple(do.shape) != tuple(q.shape):
        raise ValueError(f"flash_attention_bwd_cuda: o {tuple(o.shape)} and do "
                         f"{tuple(do.shape)} must be q's shape {tuple(q.shape)}")
    if o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError("flash_attention_bwd_cuda: o and do must take q's dtype")
    if tuple(lse.shape) != (B, H, S) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd_cuda: lse must be float32 {(B, H, S)}")
    if not all(t.is_contiguous() for t in (q, k, v, o, lse, do)):
        raise ValueError("flash_attention_bwd_cuda: q, k, v, o, lse, do must be contiguous")
    if not bwd_launchable(hd, dtype, block_q, block_kv, kv_split, H // KV):
        raise ValueError(
            f"flash_attention_bwd_cuda: {dtype} tile (hd={tile_hd(hd, dtype)}, {block_q}, "
            f"{block_kv}) with kv_split {kv_split} over a group of {H // KV} is not "
            f"instantiated"
        )
    smem = bwd_smem_bytes(block_q, block_kv, hd, q.element_size())
    limit = smem_optin(q.device)
    if smem > limit:
        raise ValueError(
            f"flash_attention_bwd_cuda: tiles ({block_q},{block_kv}) need {smem} B "
            f"of shared memory, the card allows {limit} B"
        )
    return B, S, H, KV, hd, dtype


def _bwd_launch(args, block_q: int, block_kv: int, kv_split: int, passes: int = _ALL_PASSES):
    """Launch the passes ``passes`` of the backward on checked inputs
    ``args`` = (q, k, v, o, lse, do); returns (dq, dk, dv) at the padded
    head dim and the buffers the launch used."""
    q, k, v, o, lse, do = args
    B, S, H, hd = q.shape
    KV = k.shape[2]
    dtype = _name(q.dtype)
    scale = 1.0 / math.sqrt(hd)
    hd_run = padded_hd(hd, dtype)
    if hd_run != hd:
        q, k, v, o, do = (pad_head_dim(t, hd_run) for t in (q, k, v, o, do))
    if any(t.data_ptr() % 16 for t in (q, k, v, o, do)):
        raise ValueError("flash_attention_bwd_cuda: the 16-byte loads need 16-byte aligned "
                         "q, k, v, o, do")
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stream = _build.stream_of(dq)
    scratch = torch.empty(bwd_scratch_bytes(B, S, KV, hd_run, kv_split) // 4,
                          dtype=torch.float32, device=q.device)
    bufs = (q, k, v, o, do, lse, delta, dq, dk, dv)  # alive as long as `run`
    sm90 = bwd_sm90(dtype)
    what = f"flash_attention_bwd_{'sm90' if sm90 else 'f32'}_launch"
    launch = (_build.function(_BWD_SM90_LIB, what, _BWD_SM90_ARGTYPES) if sm90
              else _build.function(_BWD_F32_LIB, what, _BWD_F32_ARGTYPES))

    def run(mask: int) -> None:
        if not sm90 and mask != _ALL_PASSES:
            raise ValueError(f"{what}: runs its passes together")
        code = launch(*(t.data_ptr() for t in bufs),
                      scratch.data_ptr() if kv_split > 1 else None,
                      B, S, H, KV, hd_run, block_q, block_kv, kv_split, scale,
                      *((mask,) if sm90 else ()), stream)
        _build.check(code, f"{what}(block_q={block_q}, block_kv={block_kv}, "
                           f"kv_split={kv_split})")
    run(passes)
    return (dq, dk, dv), run


def flash_attention_bwd_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, block_q: int = 64, block_kv: int = 64, kv_split: int = 1,
):
    """Launch the backward kernel on contiguous CUDA tensors (f32 or bf16):
    (dq, dk, dv) of causal attention.  ``kv_split`` (any divisor of the
    query heads a KV head) splits each group's
    dk/dv sum over that many CTAs, whose float32 partials a reduce pass
    adds in order.  An hd off the kernels' rule runs padded, as the forward
    does: q, k, v, o and do copied into :func:`padded_hd` columns (zero
    columns add nothing to a score, to delta or to a kept gradient column),
    the true hd's scale, and the first hd columns of each gradient
    returned."""
    B, S, H, KV, hd, dtype = _bwd_inputs(q, k, v, o, lse, do, block_q, block_kv, kv_split)
    (dq, dk, dv), _ = _bwd_launch((q, k, v, o, lse, do), block_q, block_kv, kv_split)
    bwd_counter.launched()
    if padded_hd(hd, dtype) != hd:
        dq, dk, dv = (t[..., :hd].contiguous() for t in (dq, dk, dv))
    return dq, dk, dv


def bwd_pass_runs(q, k, v, o, lse, do, block_q: int = 64, block_kv: int = 64,
                  kv_split: int = 1) -> dict:
    """The wgmma backward's passes one at a time, for timing: runs the whole
    call once (not counted as a launch), then returns {pass name: a
    function launching that pass alone on the call's buffers}; "reduce"
    only where ``kv_split`` is above 1."""
    B, S, H, KV, hd, dtype = _bwd_inputs(q, k, v, o, lse, do, block_q, block_kv, kv_split)
    if not bwd_sm90(dtype):
        raise ValueError("bwd_pass_runs: the passes of the wgmma kernel only (bf16)")
    _, run = _bwd_launch((q, k, v, o, lse, do), block_q, block_kv, kv_split)
    return {name: (lambda bit=bit: run(bit)) for name, bit in BWD_PASSES.items()
            if name != "reduce" or kv_split > 1}


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, block_q: int = 64, block_kv: int = 64, kv_split: int = 1,
):
    """(dq, dk, dv) of causal GQA attention: the CUDA kernel on CUDA
    tensors, the plain version on CPU tensors (tiles are checked either
    way)."""
    if _build.route((q, k, v, o, lse, do), "flash_attention_bwd") == "cuda":
        return flash_attention_bwd_cuda(q, k, v, o, lse, do, block_q, block_kv, kv_split)
    _check(q, k, v, block_q, block_kv)
    bwd_counter.ran_plain()
    return attention_bwd_plain(q, k, v, o, lse, do)


def _name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    block_q: int = 64, block_kv: int = 64, causal: bool = True, return_lse: bool = False,
):
    """Causal GQA attention: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors (tiles are checked either way); with
    ``return_lse``, (o, lse)."""
    if _build.route((q, k, v), "flash_attention") == "cuda":
        return flash_attention_cuda(q, k, v, block_q, block_kv, causal, return_lse)
    _check(q, k, v, block_q, block_kv)
    counter.ran_plain()
    return attention_plain(q, k, v, causal=causal, return_lse=return_lse)


_OPTIN = {}


def smem_optin(device="cuda") -> int:
    """The card's opt-in shared memory per block, as CUDA reports it
    (``cudaDevAttrMaxSharedMemoryPerBlockOptin``; builds the kernels)."""
    device = torch.device(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _OPTIN:
        fn = _build.function("flash_attention", "flash_attention_smem_optin",
                             [ctypes.c_int])
        _OPTIN[index] = int(fn(index))
    return _OPTIN[index]


_CTAS = {}
_CTAS_ENTRY = {"bfloat16": ("flash_attention_sm90", "flash_attention_sm90_ctas_per_sm"),
               "float32": ("flash_attention", "flash_attention_ctas_per_sm")}


def ctas_per_sm(hd: int, block_q: int, block_kv: int, dtype: str = "bfloat16") -> int:
    """CTAs of a tile one SM of the current card holds at once, as CUDA's
    occupancy calculator counts them from the compiled kernel's registers,
    shared memory and threads
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``; builds the
    kernels)."""
    key = (torch.cuda.current_device(), dtype, hd, block_q, block_kv)
    if key not in _CTAS:
        lib, entry = _CTAS_ENTRY[dtype]
        n = int(_build.function(lib, entry, [ctypes.c_int] * 3)(hd, block_q, block_kv))
        if n < 1:
            raise RuntimeError(f"{entry}({hd}, {block_q}, {block_kv}) returned {n}")
        _CTAS[key] = n
    return _CTAS[key]


def smem_bytes_native(block_q: int, block_kv: int, hd: int, dtype) -> int:
    """What the compiled source computes for :func:`smem_bytes` (a check
    that the Python model is the kernel's real footprint); -1 for a tile
    that is not instantiated."""
    if dtype == torch.bfloat16:
        fn = _build.function("flash_attention_sm90", "flash_attention_sm90_smem_bytes",
                             [ctypes.c_int] * 3, ctypes.c_longlong)
        return int(fn(hd, block_q, block_kv))
    fn = _build.function("flash_attention", "flash_attention_smem_bytes",
                         [ctypes.c_int] * 4, ctypes.c_longlong)
    return int(fn(_DTYPES[dtype], hd, block_q, block_kv))


def bwd_smem_bytes_native(block_q: int, block_kv: int, hd: int, dtype) -> int:
    """What the compiled backward source computes for
    :func:`bwd_smem_bytes`; -1 for a tile that is not instantiated."""
    if bwd_sm90(_name(dtype)):
        lib, entry = _BWD_SM90_LIB, "flash_attention_bwd_sm90_smem_bytes"
    else:
        lib, entry = _BWD_F32_LIB, "flash_attention_bwd_f32_smem_bytes"
    fn = _build.function(lib, entry, [ctypes.c_int] * 3, ctypes.c_longlong)
    return int(fn(hd, block_q, block_kv))


def bwd_scratch_bytes_native(B: int, S: int, KV: int, hd: int, kv_split: int) -> int:
    """What the compiled wgmma backward computes for :func:`bwd_scratch_bytes`."""
    fn = _build.function(_BWD_SM90_LIB, "flash_attention_bwd_sm90_scratch_bytes",
                         [ctypes.c_int] * 5, ctypes.c_longlong)
    return int(fn(B, S, KV, hd, kv_split))


_BWD_CTAS = {}


def bwd_ctas_per_sm(hd: int, block_q: int, block_kv: int, which: str) -> int:
    """CTAs of the wgmma backward's pass ``which`` ("dq" or "dkv") one SM of
    the current card holds at once, as CUDA's occupancy calculator counts
    them (builds the kernels)."""
    key = (torch.cuda.current_device(), hd, block_q, block_kv, which)
    if key not in _BWD_CTAS:
        fn = _build.function(_BWD_SM90_LIB, "flash_attention_bwd_sm90_ctas_per_sm",
                             [ctypes.c_int] * 4)
        n = int(fn(hd, block_q, block_kv, 0 if which == "dq" else 1))
        if n < 1:
            raise RuntimeError(f"flash_attention_bwd_sm90_ctas_per_sm({hd}, {block_q}, "
                               f"{block_kv}, {which}) returned {n}")
        _BWD_CTAS[key] = n
    return _BWD_CTAS[key]
