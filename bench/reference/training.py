"""The training steps of any reference model: a loss, its gradients in
float32, and AdamW (:mod:`reference.adamw`), one step a batch.

A training reference is a module with ``loss(params, tokens, targets, m,
mm)``; :func:`follow` takes that loss and runs the steps."""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence

import torch

from .adamw import AdamW


def leaves_of(tree: Any, prefix: str = "") -> List:
    """``(dotted name, tensor)`` of every leaf, dict keys sorted, lists by index."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in leaves_of(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, list):
        return [kv for i, v in enumerate(tree) for kv in leaves_of(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def follow(loss: Callable, params, batches: Sequence[Dict[str, torch.Tensor]],
           model: Dict[str, Any], adamw: Dict[str, float], mm: Callable,
           half_batch: bool = False) -> Dict[str, Any]:
    """Train float32 ``params`` (a tree, updated in place) on ``loss`` one
    step a batch.

    Returns each step's loss, each leaf's norm of the first gradient as
    AdamW took it (clipped), and each leaf's norm of the change of the
    parameters over all the steps, by leaf name.  ``half_batch`` trains on
    the first half of each batch's rows (a fault the comparison must see)."""
    named = leaves_of(params)
    names = [n for n, _ in named]
    leaves = [t for _, t in named]
    start = [t.detach().clone() for t in leaves]
    opt = AdamW(adamw, leaves)
    losses, first = [], None
    for batch in batches:
        tokens, targets = batch["tokens"], batch["targets"]
        if half_batch:
            tokens, targets = tokens[: len(tokens) // 2], targets[: len(targets) // 2]
        for t in leaves:
            t.requires_grad_(True)
        with torch.enable_grad():
            value = loss(params, tokens, targets, model, mm)
            grads = torch.autograd.grad(value, leaves, allow_unused=True)
        for t in leaves:
            t.requires_grad_(False)
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
        losses.append(float(value.detach()))
        norms = opt.step(leaves, grads)
        del grads
        if first is None:
            first = norms
    change = [float(torch.linalg.vector_norm(t - s)) for t, s in zip(leaves, start)]
    return {"loss": losses, "grad": dict(zip(names, first)), "change": dict(zip(names, change))}
