"""The weights a cell runs on, drawn from ``--seed`` on the device.

The benchmark makes the weights and hands the same tensors to the program
and, drawn again from the same seed, to the plain reference.  Every random
leaf is a view of one buffer filled by one ``normal_`` call on a generator
on the device, in the dtype the weights are served in, then scaled in
place by the standard deviation the configuration file's ``init`` block
gives for the leaf's name; ``"ones"`` and ``"zeros"`` leaves are filled.
The tree is the layout the program takes (nested dicts, a list of layers),
as the configuration's reference module gives it (``layout``, found by
name: :mod:`harness.family`).
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

from . import family

DTYPES = ("float32", "bfloat16")


def leaf_dtype(precision: Dict[str, str], shape: Tuple[int, ...]) -> str:
    """A leaf's dtype: ``precision["vectors"]`` for 1-D leaves where given,
    else ``precision["params"]``."""
    name = precision.get("vectors", precision["params"]) if len(shape) == 1 \
        else precision["params"]
    if name not in DTYPES:
        raise ValueError(f"unknown parameter dtype {name!r}")
    return name


def _set(tree: Dict[str, Any], path: Tuple, value: Any) -> None:
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(key, int):
            while len(node) <= key:
                node.append({})
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    node[path[-1]] = value


def draw(config: Dict[str, Any], seed: int, device: Any, precision: Dict[str, str] = None):
    """The weight tree of ``config`` drawn from ``seed`` on ``device``."""
    import torch

    init = config["init"]
    precision = precision or config["precision"]
    leaves = family.reference_of(config).layout(family.sizes(config))
    random = [(p, sh) for p, sh in leaves if not isinstance(init[p[-1]], str)]
    dtypes = {leaf_dtype(precision, sh) for _, sh in random}
    gen = torch.Generator(device=device).manual_seed(int(seed))
    buffers = {}
    for name in sorted(dtypes):  # one buffer, one normal_ call, per dtype
        n = sum(torch.Size(sh).numel() for _, sh in random if leaf_dtype(precision, sh) == name)
        buffers[name] = torch.empty(n, dtype=getattr(torch, name), device=device)
        buffers[name].normal_(generator=gen)
    offsets = {name: 0 for name in buffers}
    tree: Dict[str, Any] = {}
    with torch.no_grad():
        for path, shape in leaves:
            rule = init[path[-1]]
            dtype = leaf_dtype(precision, shape)
            if rule == "ones":
                t = torch.ones(shape, dtype=getattr(torch, dtype), device=device)
            elif rule == "zeros":
                t = torch.zeros(shape, dtype=getattr(torch, dtype), device=device)
            elif isinstance(rule, str):
                raise ValueError(f"unknown init {rule!r} for {path[-1]}")
            else:
                n = torch.Size(shape).numel()
                t = buffers[dtype][offsets[dtype]:offsets[dtype] + n].view(shape)
                offsets[dtype] += n
                t.mul_(float(rule))
            _set(tree, path, t)
    return tree


def leaves_of(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(dotted name, tensor)`` of every leaf, dict keys sorted and lists by
    index (the order the program's optimizer walks)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves_of(tree[k], f"{prefix}{k}.")
        return out
    if isinstance(tree, list):
        out = []
        for i, v in enumerate(tree):
            out += leaves_of(v, f"{prefix}{i}.")
        return out
    return [(prefix[:-1], tree)]
