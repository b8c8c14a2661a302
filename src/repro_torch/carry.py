"""Carry the JAX side's kernel inputs across to the port.

This slice has no model weights: what crosses is each kernel's inputs and
the tuning record.  The inputs arrive as numpy arrays (``np.asarray`` of
the JAX side's arrays) and leave as tensors in the same layout, so both
packages compute the same thing:

* ``exb``: the dict of 13 float32 arrays (``vl`` and the 4-D/3-D fields);
* ``flash_attention``: ``(q, k, v)`` in ``(B, S, heads, hd)``;
* ``stress``: the dict of 17 float32 ``(nk, nj, ni)`` fields;
* ``ssm_scan``: ``(x, dt, A, Bc, Cc, D)`` in the JAX positional order;
* ``rglru_scan``: ``(x, r, i, lam)``;
* the apps' loop nests: GKV's dict of six complex64 fields and ``vl``
  (float32), Seism3D's dict of 17 float32 fields, every field at the full
  domain shape.

The tuning record needs no conversion: the port's TuningDB writes the same
schema v2 file the JAX package reads.  bf16 has no numpy type, so a bf16
array is carried as float32 and cast on the device; the scans' inputs keep
their bf16 (or take the ``dtype`` the caller names).  Tensors land on the
card unless the caller passes ``device="cpu"`` (as the CPU tests do), where
the kernels' plain versions run.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch


def to_tensor(a: Any, device: Any = "cuda", dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One array as a contiguous tensor on ``device`` (copied, never shared)."""
    arr = np.array(a, copy=True)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16: carried as float32
        arr = arr.astype(np.float32)
    t = torch.from_numpy(arr)
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device).contiguous()


def exb_inputs(arrays: Mapping[str, Any], device: Any = "cuda") -> Dict[str, torch.Tensor]:
    """The exb input dict, field by field, as float32 tensors."""
    return {name: to_tensor(a, device, torch.float32) for name, a in arrays.items()}


def attention_inputs(
    q: Any, k: Any, v: Any, device: Any = "cuda",
    dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(q, k, v)`` as tensors in the same ``(B, S, heads, hd)`` layout."""
    return tuple(to_tensor(a, device, dtype) for a in (q, k, v))


def stress_inputs(arrays: Mapping[str, Any], device: Any = "cuda") -> Dict[str, torch.Tensor]:
    """The stress input dict, field by field, as float32 tensors."""
    return {name: to_tensor(a, device, torch.float32) for name, a in arrays.items()}


def _scan_dtype(a: Any, dtype: Optional[torch.dtype]) -> torch.dtype:
    """The dtype a scan's inputs take: ``dtype`` if given, else bfloat16
    for a bf16 array and float32 for anything else."""
    if dtype is not None:
        return dtype
    return torch.bfloat16 if np.asarray(a).dtype.name == "bfloat16" else torch.float32


def ssm_inputs(
    x: Any, dt: Any, A: Any, Bc: Any, Cc: Any, D: Any, device: Any = "cuda",
    dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, ...]:
    """``(x, dt, A, Bc, Cc, D)`` as tensors in the same layouts: x, dt, Bc
    and Cc in one dtype (x's, or ``dtype``), A and D in float32 as the
    kernel keeps them."""
    dt_ = _scan_dtype(x, dtype)
    return (to_tensor(x, device, dt_), to_tensor(dt, device, dt_),
            to_tensor(A, device, torch.float32), to_tensor(Bc, device, dt_),
            to_tensor(Cc, device, dt_), to_tensor(D, device, torch.float32))


def rglru_inputs(
    x: Any, r: Any, i: Any, lam: Any, device: Any = "cuda",
    dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, ...]:
    """``(x, r, i, lam)`` as tensors in the same ``(B, S, W)``/``(W,)``
    layouts: x, r and i in one dtype (x's, or ``dtype``), lam in float32."""
    dt_ = _scan_dtype(x, dtype)
    return (to_tensor(x, device, dt_), to_tensor(r, device, dt_), to_tensor(i, device, dt_),
            to_tensor(lam, device, torch.float32))


def gkv_inputs(arrays: Mapping[str, Any], device: Any = "cuda") -> Dict[str, torch.Tensor]:
    """The GKV loop nest's input dict: complex fields stay complex64,
    ``vl`` float32."""
    return {name: to_tensor(a, device, torch.complex64 if np.iscomplexobj(a) else torch.float32)
            for name, a in arrays.items()}


def seism_inputs(arrays: Mapping[str, Any], device: Any = "cuda") -> Dict[str, torch.Tensor]:
    """The Seism3D loop nest's input dict, field by field, as float32."""
    return {name: to_tensor(a, device, torch.float32) for name, a in arrays.items()}


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A port result back to numpy, in float32 (bf16 has no numpy type)."""
    return t.detach().to("cpu", torch.float32).numpy()
