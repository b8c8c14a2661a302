"""AdamW with warmup + cosine schedule and global-norm clipping.

The port of ``repro.optim.adamw`` over the port's parameter trees (nested
dicts and lists of tensors, :mod:`repro_torch.tree`).  The arithmetic is the
JAX package's, in float32: the bias corrections ``1 - b**count`` as float32
tensors, the clip scale ``min(1, clip / (‖g‖ + 1e-12))`` with the norm
reported before clipping, decoupled weight decay on every leaf, moments
kept in ``moment_dtype`` (``"float32"`` or ``"bfloat16"``) and the updated
parameters rounded back to their own dtype.

The functions are pure, as the JAX ones are: :func:`adamw_update` returns
new parameters and a new state and leaves its arguments as they were (the
joint tuner runs trial steps on the live state).  The update runs as
``torch._foreach_*`` ops (the JAX package leaves it to XLA; no kernel
replaces it) over runs of leaves of at most ``GROUP_ELEMENTS`` elements,
so its float32 temporaries stay bounded at any model size (every op is
elementwise, so the groups change no bit), with the step's scalars
(learning rate, clip scale, bias corrections) read to the host once a
step.  :func:`adamw_init_specs` gives the state's specs for the
dry-run, which runs :func:`adamw_update` on DTensors of fake tensors:
there the step's scalars hold no value, and the update runs on 1.0 in
their place (it counts the work, and its numbers are never read).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Tuple

import torch

from ..models.spec import ParamSpec, map_specs
from ..tree import flatten, tree_map, unflatten

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    moment_dtype: str = "float32"  # "float32" | "bfloat16"


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to min_lr_ratio·lr (float32)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr * step / max(1, cfg.warmup_steps)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0
    )
    cos = cfg.lr * (cfg.min_lr_ratio
                    + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params: Any, cfg: AdamWConfig) -> Dict[str, Any]:
    """``{m, v, count}``: zero moments like each leaf, in the moment dtype."""
    mdt = _DTYPES[cfg.moment_dtype]
    zeros = lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device)  # noqa: E731
    leaves, _ = flatten(params)
    device = leaves[0].device if leaves else "cpu"
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def adamw_init_specs(spec_tree: Any, cfg: AdamWConfig) -> Dict[str, Any]:
    """Optimizer-state *specs* (for the dry-run: shapes, logical axes)."""
    mdt = _DTYPES[cfg.moment_dtype]
    tree = map_specs(lambda s: ParamSpec(s.shape, s.logical_axes, dtype=mdt, init="zeros"),
                     spec_tree)
    return {
        "m": tree,
        "v": tree,
        "count": ParamSpec((), (), dtype=torch.int32, init="zeros"),
    }


def _holds_values(t: torch.Tensor) -> bool:
    """False for a tensor with no data: meta, fake, or a DTensor of them."""
    from torch._subclasses.fake_tensor import is_fake

    t = getattr(t, "_local_tensor", t)
    return not (t.is_meta or is_fake(t))


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares,
    summed leaf by leaf in tree order."""
    leaves, _ = flatten(tree)
    total = sum(torch.sum(torch.square(x.float())) for x in leaves)
    return torch.sqrt(total)


# Leaves a group of the update takes at once, by elements: each of its
# float32 temporaries (the gradient scaled, the step, the parameters
# upcast, the update) is at most 1 GiB, whatever the model's size.
GROUP_ELEMENTS = 1 << 28


def _groups(leaves: List[torch.Tensor]) -> Iterator[List[int]]:
    """Runs of consecutive leaf indices of at most GROUP_ELEMENTS elements
    (a larger leaf alone)."""
    part, size = [], 0
    for i, t in enumerate(leaves):
        if part and size + t.numel() > GROUP_ELEMENTS:
            yield part
            part, size = [], 0
        part.append(i)
        size += t.numel()
    if part:
        yield part


def adamw_update(
    grads: Any, opt_state: Dict[str, Any], params: Any, cfg: AdamWConfig,
) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step.  Returns (params, opt_state, metrics) and mutates
    none of its arguments."""
    count = opt_state["count"] + 1
    lr = lr_at(cfg, count)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-12), max=1.0)
    c = count.to(torch.float32)
    bc1 = 1.0 - cfg.b1 ** c
    bc2 = 1.0 - cfg.b2 ** c
    scalars = torch.stack([lr, scale, bc1, bc2])
    if _holds_values(scalars):
        lr_f, scale_f, bc1_f, bc2_f = (float(x) for x in scalars.cpu())
    else:
        lr_f = scale_f = bc1_f = bc2_f = 1.0
    mdt = _DTYPES[cfg.moment_dtype]

    flat_p, structure = flatten(params)
    flat_g = flatten(grads)[0]
    flat_m = flatten(opt_state["m"])[0]
    flat_v = flatten(opt_state["v"])[0]

    out_p, out_m, out_v = [], [], []
    for part in _groups(flat_p):
        p_, g_, m_, v_ = ([flat[i] for i in part] for flat in (flat_p, flat_g, flat_m, flat_v))
        # every list below is fresh (out-of-place first op), so the in-place
        # ops that follow never touch a caller's tensor
        gf = torch._foreach_mul([g.float() for g in g_], scale_f)
        m_new = torch._foreach_mul([m.float() for m in m_], cfg.b1)
        torch._foreach_add_(m_new, gf, alpha=1 - cfg.b1)
        v_new = torch._foreach_mul([v.float() for v in v_], cfg.b2)
        torch._foreach_addcmul_(v_new, gf, gf, value=1 - cfg.b2)
        del gf
        step = torch._foreach_div(m_new, bc1_f)
        den = torch._foreach_div(v_new, bc2_f)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, cfg.eps)
        torch._foreach_div_(step, den)
        del den
        pf = [p.float() for p in p_]
        upd = torch._foreach_mul(pf, cfg.weight_decay)
        torch._foreach_add_(upd, step)
        torch._foreach_mul_(upd, lr_f)
        del step
        new_p = torch._foreach_sub(pf, upd)
        del upd, pf
        out_p += [x.to(p.dtype) for x, p in zip(new_p, p_)]
        out_m += [x.to(mdt) for x in m_new]
        out_v += [x.to(mdt) for x in v_new]
        del new_p, m_new, v_new

    new_params = unflatten(structure, out_p)
    new_state = {
        "m": unflatten(structure, out_m),
        "v": unflatten(structure, out_v),
        "count": count,
    }
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}
