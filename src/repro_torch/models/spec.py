"""Parameter specs and the parameter tree: shapes, init rules, allocation.

Every model of the zoo describes its parameters as a tree of
:class:`ParamSpec` (shape, logical axis names, dtype, init rule), as the
JAX package's ``repro.models.spec`` does, with torch dtypes.  One
difference of layout: where the JAX package stacks homogeneous layers on a
leading ``layers`` axis (for ``lax.scan``), the port's tree holds a list
with one dict per layer, and :func:`init_params` turns it into an
``nn.ModuleList`` (the hybrid family's groups and tail become one list in
layer order).  ``repro_torch.carry.model_params`` maps the JAX tree onto
this one.

:class:`Params` is the allocated tree: an ``nn.Module`` whose children are
its keys, each a parameter (a leaf), a :class:`Params` (a dict) or an
``nn.ModuleList`` (the layers), indexed as the JAX functions index their
dicts (``p["attn"]["wq"]``, ``"bq" in p``).  Parameters do not take
gradients: the models are served; training is not ported yet.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Iterator, Mapping, Optional, Tuple, Union

import torch
from torch import nn


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical_axes: Tuple[Optional[str], ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"  # "normal" | "zeros" | "ones" | "rglru_lambda"
    init_scale: Optional[float] = None  # overrides fan-in scaling

    def __post_init__(self) -> None:
        if len(self.shape) != len(self.logical_axes):
            raise ValueError(
                f"shape {self.shape} vs logical_axes {self.logical_axes} length mismatch"
            )

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def spec_leaves(tree: Any) -> Iterator[ParamSpec]:
    """The specs of a tree of dicts and lists, in key and list order."""
    if isinstance(tree, ParamSpec):
        yield tree
    elif isinstance(tree, Mapping):
        for v in tree.values():
            yield from spec_leaves(v)
    else:
        for v in tree:
            yield from spec_leaves(v)


def count_params(tree: Any) -> int:
    return sum(spec.size for spec in spec_leaves(tree))


class Params(nn.Module):
    """A dict of parameters and sub-trees that is also an ``nn.Module``
    (so ``.to``, ``state_dict`` and ``parameters`` see every leaf)."""

    def __init__(self, items: Mapping[str, Union[torch.Tensor, nn.Module]]) -> None:
        super().__init__()
        self._order = []
        for key, value in items.items():
            if isinstance(value, nn.Module):
                self.add_module(key, value)
            else:
                self.register_parameter(key, nn.Parameter(value, requires_grad=False))
            self._order.append(key)

    def __getitem__(self, key: str):
        if key not in self._order:
            raise KeyError(key)
        return getattr(self, key)

    def __contains__(self, key: object) -> bool:
        return key in self._order

    def items(self):
        return [(k, getattr(self, k)) for k in self._order]


def build_params(tree: Any) -> Union[Params, nn.ModuleList, torch.Tensor]:
    """A tree of dicts, lists and tensors as :class:`Params` (dicts),
    ``nn.ModuleList`` (lists) and parameters (tensors)."""
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, Mapping):
        return Params({k: build_params(v) for k, v in tree.items()})
    return nn.ModuleList([build_params(v) for v in tree])


def init_params(tree: Any, generator: torch.Generator, device: Any = "cuda") -> Params:
    """Materialize the spec tree on ``device``, every random leaf drawn from
    ``generator`` (which must live on ``device``'s type), in tree order."""

    def walk(node):
        if isinstance(node, ParamSpec):
            return _init_leaf(node, generator, device)
        if isinstance(node, Mapping):
            return {k: walk(v) for k, v in node.items()}
        return [walk(v) for v in node]

    return build_params(walk(tree))


def _init_leaf(spec: ParamSpec, generator: torch.Generator, device: Any) -> torch.Tensor:
    """The JAX package's init rules (``repro.models.spec._init_leaf``)."""
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "rglru_lambda":
        # RG-LRU Λ init: a = sigmoid(Λ) uniform in [0.9, 0.999] (Griffin §2.4)
        u = 0.9 + 0.099 * torch.rand(spec.shape, generator=generator, dtype=torch.float32,
                                     device=device)
        return torch.log(u / (1.0 - u)).to(spec.dtype)
    # fan-in scaled normal; fan-in = second-to-last dim for matrices
    if spec.init_scale is not None:
        scale = spec.init_scale
    elif len(spec.shape) >= 2:
        scale = 1.0 / math.sqrt(max(1, spec.shape[-2]))
    else:
        scale = 0.02
    x = torch.randn(spec.shape, generator=generator, dtype=torch.float32, device=device)
    return (x * scale).to(spec.dtype)
