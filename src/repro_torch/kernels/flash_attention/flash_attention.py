"""Wrapper of the hand-written CUDA flash attention kernel
(``csrc/flash_attention.cu``).

``flash_attention(q, k, v, block_q, block_kv)`` launches the kernel on CUDA
tensors and runs the plain version (:func:`attention_plain`, the module's
copy of ``ref.attention_ref``) on CPU tensors; there is no fallback from
one to the other.  ``counter`` counts both.

One CTA per (q block, head, batch); ``block_kv`` is a loop inside the CTA.
Any positive tile is accepted as long as its shared memory
(:func:`smem_bytes`) fits the card's opt-in limit; a sequence that the
tiles do not divide is masked in the kernel, not padded in memory.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _build
from .ref import attention_ref

attention_plain = attention_ref
counter = _build.Counter()

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int,
                                                 ctypes.c_void_p]
)


def smem_bytes(block_q: int, block_kv: int, hd: int, elt: int) -> int:
    """Dynamic shared memory of one CTA (``smem_bytes`` in the source):
    f32 scores, accumulator and m/l/alpha, then the q, k and v tiles with
    one extra 32-bit word per row."""
    floats = block_q * block_kv + block_q * hd + 3 * block_q
    ld = hd + 4 // elt
    return 4 * floats + elt * (block_q + 2 * block_kv) * ld


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
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention_cuda: dtype {q.dtype} not supported")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head_dim {hd} not in {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_cuda: q, k, v must be contiguous")
    smem = smem_bytes(block_q, block_kv, hd, q.element_size())
    limit = smem_optin(q.device)
    if smem > limit:
        raise ValueError(
            f"flash_attention_cuda: tiles ({block_q},{block_kv}) need {smem} B "
            f"of shared memory, the card allows {limit} B"
        )
    o = torch.empty_like(q)
    code = _build.function("flash_attention", "flash_attention_launch", _ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), _DTYPES[q.dtype],
        B, S, H, KV, hd, block_q, block_kv, 1.0 / math.sqrt(hd), int(causal),
        _build.stream_of(o),
    )
    _build.check(code, f"flash_attention_launch(block_q={block_q}, block_kv={block_kv})")
    counter.launches += 1
    return o


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    block_q: int = 64, block_kv: int = 64, causal: bool = True,
) -> torch.Tensor:
    """Causal GQA attention: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors (tiles are checked either way)."""
    if _build.route((q, k, v), "flash_attention") == "cuda":
        return flash_attention_cuda(q, k, v, block_q, block_kv, causal)
    _check(q, k, v, block_q, block_kv)
    counter.plain_calls += 1
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


def smem_bytes_native(block_q: int, block_kv: int, hd: int, dtype) -> int:
    """What the compiled source computes for :func:`smem_bytes` (a check
    that the Python model is the kernel's real footprint)."""
    fn = _build.function("flash_attention", "flash_attention_smem_bytes",
                         [ctypes.c_int] * 4, ctypes.c_longlong)
    return int(fn(_DTYPES[dtype], hd, block_q, block_kv))
