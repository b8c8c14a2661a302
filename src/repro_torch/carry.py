"""Carry the JAX side's kernel inputs and model weights across to the port.

What crosses is each kernel's inputs, a model's parameters and the tuning
record.  The inputs arrive as numpy arrays (``np.asarray`` of the JAX
side's arrays) and leave as tensors in the same layout, so both packages
compute the same thing:

* ``exb``: the dict of 13 float32 arrays (``vl`` and the 4-D/3-D fields);
* ``flash_attention``: ``(q, k, v)`` in ``(B, S, heads, hd)``;
* ``stress``: the dict of 17 float32 ``(nk, nj, ni)`` fields;
* ``ssm_scan``: ``(x, dt, A, Bc, Cc, D)`` in the JAX positional order;
* ``rglru_scan``: ``(x, r, i, lam)``;
* the apps' loop nests: GKV's dict of six complex64 fields and ``vl``
  (float32), Seism3D's dict of 17 float32 fields, every field at the full
  domain shape;
* a model's parameters (:func:`model_params`): the JAX ``init_params``
  tree, whose homogeneous layers are stacked on a leading axis (the hybrid
  family's as pattern groups and a tail), as the port's tree of one entry
  per layer; :func:`model_arrays` takes it back.

The tuning record needs no conversion: the port's TuningDB writes the same
schema v2 file the JAX package reads.  bf16 has no numpy type, so a bf16
array is carried as float32 and cast on the device; the scans' inputs keep
their bf16 (or take the ``dtype`` the caller names).  Tensors land on the
card unless the caller passes ``device="cpu"`` (as the CPU tests do), where
the kernels' plain versions run.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from .models.config import ModelConfig
from .models.model import param_specs
from .models.spec import ParamSpec, Params, build_params
from .models.transformer import hybrid_slot


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


# -- model weights -------------------------------------------------------------

_STACKED = ("layers", "enc_layers", "dec_layers")


def _map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _per_layer(cfg: ModelConfig, arrays: Mapping[str, Any]) -> Dict[str, Any]:
    """The JAX tree with its stacked layers split into lists in layer order."""
    tree: Dict[str, Any] = {}
    for key, val in arrays.items():
        if key in _STACKED:
            n = cfg.n_encoder_layers if key == "enc_layers" else cfg.n_layers
            tree[key] = [_map(lambda a, i=i: np.asarray(a)[i], val) for i in range(n)]
        elif key not in ("groups", "tail"):
            tree[key] = val
    if cfg.family == "hybrid":
        layers: List[Any] = [None] * cfg.n_layers
        for i in range(cfg.n_layers):
            prefix, g = hybrid_slot(cfg, i)
            kind = cfg.block_pattern[i % len(cfg.block_pattern)]
            if g is not None:
                layers[i] = _map(lambda a, g=g: np.asarray(a)[g],
                                 arrays["groups"][f"{prefix}_{kind}"])
            elif f"t_{kind}" in arrays["tail"]:  # a stacked homogeneous tail
                t = int(prefix[1:])
                layers[i] = _map(lambda a, t=t: np.asarray(a)[t], arrays["tail"][f"t_{kind}"])
            else:  # an unrolled tail layer
                layers[i] = arrays["tail"][f"{prefix}_{kind}"]
        tree["layers"] = layers
    return tree


def model_params(
    cfg: ModelConfig, arrays: Mapping[str, Any], device: Any = "cuda",
    dtype: Optional[torch.dtype] = None,
) -> Params:
    """The JAX ``init_params`` tree of ``cfg`` (numpy leaves, or anything
    ``np.asarray`` takes) as the port's parameters on ``device``: each
    leaf in its own dtype (bf16 stays bf16, carried through float32) or
    in ``dtype``; every leaf's shape is checked against the port's spec."""
    per_layer = _per_layer(cfg, arrays)

    def walk(spec, node, path):
        if isinstance(spec, ParamSpec):
            a = np.asarray(node)
            if tuple(a.shape) != tuple(spec.shape):
                raise ValueError(f"{cfg.name} {path}: shape {a.shape}, spec {spec.shape}")
            leaf_dtype = dtype or (torch.bfloat16 if a.dtype.name == "bfloat16"
                                   else torch.float32)
            return to_tensor(a, device, leaf_dtype)
        if isinstance(spec, Mapping):
            return {k: walk(v, node[k], f"{path}/{k}") for k, v in spec.items()}
        return [walk(v, node[i], f"{path}/{i}") for i, v in enumerate(spec)]

    return build_params(walk(param_specs(cfg), per_layer, ""))


def model_arrays(cfg: ModelConfig, params: Params) -> Dict[str, Any]:
    """The port's parameters back in the JAX package's tree (stacked
    layers, the hybrid family's groups and tail), as float32 numpy."""

    def to_np(node):
        if isinstance(node, torch.Tensor):
            return to_numpy(node)
        return {k: to_np(v) for k, v in node.items()}

    def stack(layers):
        first = layers[0]
        if isinstance(first, np.ndarray):
            return np.stack(layers)
        return {k: stack([layer[k] for layer in layers]) for k in first}

    out: Dict[str, Any] = {}
    for key, val in params.items():
        if key in _STACKED and not (key == "layers" and cfg.family == "hybrid"):
            out[key] = stack([to_np(layer) for layer in val])
        elif key != "layers":
            out[key] = to_np(val)
    if cfg.family == "hybrid":
        period = len(cfg.block_pattern)
        n_groups, n_tail = divmod(cfg.n_layers, period)
        layers = [to_np(layer) for layer in params["layers"]]
        out["groups"] = {
            f"b{idx}_{kind}": stack(layers[idx:n_groups * period:period])
            for idx, kind in enumerate(cfg.block_pattern)
        }
        if n_tail:
            kinds = cfg.block_pattern[:n_tail]
            tail = layers[n_groups * period:]
            out["tail"] = ({f"t_{kinds[0]}": stack(tail)} if len(set(kinds)) == 1 else
                           {f"t{idx}_{kind}": tail[idx] for idx, kind in enumerate(kinds)})
    return out
