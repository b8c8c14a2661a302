"""Trees of tensors: nested dicts and lists, as a parameter tree or an
optimizer state is held in training.

Leaves are flattened in the JAX package's pytree order (dict keys sorted,
lists by index), so the optimizer walks leaves and a checkpoint stores
them in the order the JAX package's ``jax.tree.flatten`` gives the same
structure: a checkpoint one package writes loads in the other.
"""
from __future__ import annotations

from typing import Any, Callable, List, Mapping, Tuple

import torch
from torch import nn

from .models.spec import Params


def flatten(tree: Any) -> Tuple[List[Any], Any]:
    """(leaves, structure): dict keys sorted, lists and tuples by index;
    anything else is a leaf."""
    leaves: List[Any] = []

    def walk(node):
        if isinstance(node, Mapping):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        leaves.append(node)
        return None

    return leaves, walk(tree)


def unflatten(structure: Any, leaves: List[Any]) -> Any:
    """The tree of ``structure`` (from :func:`flatten`) with ``leaves`` in order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, list):
            return [build(v) for v in node]
        return next(it)

    out = build(structure)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the structure holds")
    return out


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` over the leaves of ``tree``."""
    leaves, structure = flatten(tree)
    return unflatten(structure, [fn(x) for x in leaves])


def as_tree(params: Any) -> Any:
    """A model's :class:`~repro_torch.models.spec.Params` (or any tree of
    them) as plain dicts and lists of its tensors, detached: the
    functional form the train step takes and returns."""
    if isinstance(params, Params):
        return {k: as_tree(v) for k, v in params.items()}
    if isinstance(params, (nn.ModuleList, list, tuple)):
        return [as_tree(v) for v in params]
    if isinstance(params, Mapping):
        return {k: as_tree(v) for k, v in params.items()}
    if isinstance(params, torch.Tensor):
        return params.detach()
    return params
