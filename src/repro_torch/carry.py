"""Carry the JAX side's kernel inputs across to the port.

This slice has no model weights: what crosses is each kernel's inputs and
the tuning record.  The inputs arrive as numpy arrays (``np.asarray`` of
the JAX side's arrays) and leave as tensors in the same layout, so both
packages compute the same thing:

* ``exb``: the dict of 13 float32 arrays (``vl`` and the 4-D/3-D fields);
* ``flash_attention``: ``(q, k, v)`` in ``(B, S, heads, hd)``.

The tuning record needs no conversion: the port's TuningDB writes the same
schema v2 file the JAX package reads.  bf16 has no numpy type, so a bf16
array is carried as float32 and cast on the device.  Tensors land on the
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


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A port result back to numpy, in float32 (bf16 has no numpy type)."""
    return t.detach().to("cpu", torch.float32).numpy()
