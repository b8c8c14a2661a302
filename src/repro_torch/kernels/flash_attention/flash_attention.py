"""Wrappers of the hand-written CUDA flash attention kernels.

``flash_attention(q, k, v, block_q, block_kv)`` launches a kernel on CUDA
tensors and runs the plain version (:func:`attention_plain`, the module's
copy of ``ref.attention_ref``) on CPU tensors; there is no fallback from
one to the other.  ``counter`` counts both.

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
from .ref import attention_ref

attention_plain = attention_ref
counter = _build.Counter()

TILE_HEAD_DIMS = (16, 32, 64, 128, 256)
HD_MAX = 256
# the kernels' hd a multiple of this: rows of whole 16-byte pieces (the
# wrapper pads any other hd up to it)
HD_MULTIPLE = {"bfloat16": 8, "float32": 4}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int,
                                                 ctypes.c_void_p]
)
_SM90_ARGTYPES = (
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int,
                                                 ctypes.c_void_p]
)

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
    block_q: int = 64, block_kv: int = 64, causal: bool = True,
) -> torch.Tensor:
    """Launch the CUDA kernel on contiguous CUDA tensors (f32 or bf16)."""
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
    if q.dtype == torch.bfloat16:
        what = "flash_attention_sm90_launch"
        code = _build.function("flash_attention_sm90", what, _SM90_ARGTYPES)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B, S, H, KV, hd_run, block_q, block_kv, scale, int(causal), _build.stream_of(o),
        )
    else:
        what = "flash_attention_launch"
        code = _build.function("flash_attention", what, _ARGTYPES)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), _DTYPES[q.dtype],
            B, S, H, KV, hd_run, block_q, block_kv, scale, int(causal), _build.stream_of(o),
        )
    _build.check(code, f"{what}(block_q={block_q}, block_kv={block_kv})")
    counter.launched()
    return o if hd_run == hd else o[..., :hd].contiguous()


def _name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    block_q: int = 64, block_kv: int = 64, causal: bool = True,
) -> torch.Tensor:
    """Causal GQA attention: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors (tiles are checked either way)."""
    if _build.route((q, k, v), "flash_attention") == "cuda":
        return flash_attention_cuda(q, k, v, block_q, block_kv, causal)
    _check(q, k, v, block_q, block_kv)
    counter.ran_plain()
    return attention_plain(q, k, v, causal=causal)


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
