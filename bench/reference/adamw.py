"""AdamW with a linear warm-up then cosine decay, and clipping by the global
norm, in float32 (decoupled weight decay, Loshchilov and Hutter)."""
from __future__ import annotations

import math
from typing import Dict, List

import torch


def lr_at(cfg: Dict[str, float], step: int) -> float:
    """The rate at optimizer step ``step`` (1 for the first)."""
    warm = int(cfg["warmup_steps"])
    if step < warm:
        return cfg["lr"] * step / max(1, warm)
    prog = min(1.0, max(0.0, (step - warm) / max(1, cfg["total_steps"] - warm)))
    ratio = cfg["min_lr_ratio"]
    return cfg["lr"] * (ratio + (1 - ratio) * 0.5 * (1 + math.cos(math.pi * prog)))


class AdamW:
    """State over a list of float32 leaves."""

    def __init__(self, cfg: Dict[str, float], leaves: List[torch.Tensor]) -> None:
        self.cfg = cfg
        self.m = [torch.zeros_like(p) for p in leaves]
        self.v = [torch.zeros_like(p) for p in leaves]
        self.count = 0

    @torch.no_grad()
    def step(self, leaves: List[torch.Tensor], grads: List[torch.Tensor]) -> List[float]:
        """Update ``leaves`` in place; returns the norm of each leaf's
        gradient as the update took it (clipped)."""
        c = self.cfg
        self.count += 1
        lr = lr_at(c, self.count)
        gnorm = math.sqrt(sum(float(torch.sum(g * g)) for g in grads))
        scale = min(1.0, c["grad_clip"] / (gnorm + 1e-12))
        bc1 = 1.0 - c["b1"] ** self.count
        bc2 = 1.0 - c["b2"] ** self.count
        taken = []
        for p, g, m, v in zip(leaves, grads, self.m, self.v):
            g = g * scale
            taken.append(float(torch.linalg.vector_norm(g)))
            m.mul_(c["b1"]).add_(g, alpha=1 - c["b1"])
            v.mul_(c["b2"]).addcmul_(g, g, value=1 - c["b2"])
            step = (m / bc1) / (torch.sqrt(v / bc2) + c["eps"])
            p.sub_(lr * (step + c["weight_decay"] * p))
        return taken
