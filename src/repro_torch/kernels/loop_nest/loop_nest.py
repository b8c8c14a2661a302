"""Wrappers of the hand-written loop-nest kernel (``csrc/loop_nest.cu``).

``exb(inputs, shape)`` and ``stress(inputs, shape)`` run one launch shape
(:class:`repro_torch.core.exchange.LaunchShape`) of the GKV or the Seism3D
body: on CUDA tensors the kernel, whose C entry point makes the shape's
outer launches itself (one call here, ``shape.launches`` kernel launches
there); on CPU tensors the plain version with the JAX package's
semantics (:func:`repro_torch.core.exchange.run_plain`).  There is no
fallback from one to the other.  ``counters["gkv"]`` and
``counters["seism3d"]`` count calls of each route; a call that reaches the
kernel counts one launch, whatever its ``shape.launches``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Mapping, Sequence

import torch

from .. import _build
from ...core.exchange import LaunchShape, run_plain
from .ref import GKV_FIELDS, SEISM_FIELDS, STRESS, exb_body, update_stress_body

counters = {"gkv": _build.Counter(), "seism3d": _build.Counter()}

_SHAPE_ARGTYPES = [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_void_p]
_PTRS = ctypes.POINTER(ctypes.c_void_p)


def _check(inputs: Mapping[str, torch.Tensor], names: Sequence[str], shape: LaunchShape,
           what: str, dtypes: Mapping[str, torch.dtype]) -> torch.Size:
    missing = [n for n in names if n not in inputs]
    if missing:
        raise ValueError(f"{what}: inputs lack {missing}")
    full = inputs[names[0]].shape
    for n in names:
        t = inputs[n]
        if t.shape != full:
            raise ValueError(f"{what}: {n} is {tuple(t.shape)}, not {tuple(full)}")
        if t.dtype != dtypes.get(n, torch.float32):
            raise ValueError(f"{what}: {n} must be {dtypes.get(n, torch.float32)}, got {t.dtype}")
    launches, ctas, chunk, inner, par_len = shape
    if min(shape) < 1 or ctas * chunk < par_len or launches * par_len * inner != full.numel():
        raise ValueError(f"{what}: launch shape {shape} does not cover {tuple(full)}")
    return full


def _launch(entry: str, names: Sequence[str], inputs, outs: Sequence[torch.Tensor],
            shape: LaunchShape, what: str) -> None:
    ins = [inputs[n] for n in names]
    if _build.route(ins + list(outs), what) != "cuda":
        raise ValueError(f"{what}: inputs must be CUDA tensors")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError(f"{what}: inputs must be contiguous")
    if any(t.data_ptr() % 8 for t in ins):
        raise ValueError(f"{what}: inputs must be 8-byte aligned")
    in_ptrs = (ctypes.c_void_p * len(ins))(*[t.data_ptr() for t in ins])
    out_arg = ((ctypes.c_void_p * len(outs))(*[t.data_ptr() for t in outs])
               if len(outs) > 1 else outs[0].data_ptr())
    launches, ctas, chunk, inner, par_len = shape
    argtypes = [_PTRS, _PTRS if len(outs) > 1 else ctypes.c_void_p] + _SHAPE_ARGTYPES
    code = _build.function("loop_nest", entry, argtypes)(
        in_ptrs, out_arg, launches, ctas, chunk * inner, par_len * inner,
        _build.stream_of(outs[0]),
    )
    _build.check(code, f"{entry}{tuple(shape)}")


_GKV_DTYPES = {n: torch.complex64 for n in GKV_FIELDS[:-1]}


def exb_cuda(inputs: Mapping[str, torch.Tensor], shape: LaunchShape) -> Dict[str, torch.Tensor]:
    """GKV ``exb_body`` in one launch shape, on contiguous CUDA tensors."""
    _check(inputs, GKV_FIELDS, shape, "loop_nest gkv", _GKV_DTYPES)
    out = torch.empty_like(inputs["wkdf1"])
    _launch("loop_nest_gkv", GKV_FIELDS, inputs, [out], shape, "loop_nest gkv")
    counters["gkv"].launches += 1
    return {"wkdf1": out}


def stress_cuda(inputs: Mapping[str, torch.Tensor], shape: LaunchShape) -> Dict[str, torch.Tensor]:
    """Seism3D ``update_stress_body`` in one launch shape, on contiguous
    CUDA tensors."""
    _check(inputs, SEISM_FIELDS, shape, "loop_nest seism3d", {})
    outs = {n: torch.empty_like(inputs[n]) for n in STRESS}
    _launch("loop_nest_seism3d", SEISM_FIELDS, inputs, list(outs.values()), shape,
            "loop_nest seism3d")
    counters["seism3d"].launches += 1
    return outs


def exb(inputs: Mapping[str, torch.Tensor], shape: LaunchShape) -> Dict[str, torch.Tensor]:
    """GKV ``exb_body`` in one launch shape: the kernel on CUDA tensors,
    the plain version on CPU tensors."""
    if _build.route(list(inputs.values()), "loop_nest gkv") == "cuda":
        return exb_cuda(inputs, shape)
    _check(inputs, GKV_FIELDS, shape, "loop_nest gkv", _GKV_DTYPES)
    counters["gkv"].plain_calls += 1
    return run_plain(exb_body, dict(inputs), shape)


def stress(inputs: Mapping[str, torch.Tensor], shape: LaunchShape) -> Dict[str, torch.Tensor]:
    """Seism3D ``update_stress_body`` in one launch shape: the kernel on
    CUDA tensors, the plain version on CPU tensors."""
    if _build.route(list(inputs.values()), "loop_nest seism3d") == "cuda":
        return stress_cuda(inputs, shape)
    _check(inputs, SEISM_FIELDS, shape, "loop_nest seism3d", {})
    counters["seism3d"].plain_calls += 1
    return run_plain(update_stress_body, dict(inputs), shape)

