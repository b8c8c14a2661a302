"""Mixture-of-Experts block with sort-based, capacity-bounded dispatch.

The port of ``repro.models.moe``: GShard-style groups, each dispatched on
its own with a per-group capacity; token→expert assignments are sorted
into a dense ``(E, C, d)`` buffer (capacity overflow drops tokens, whose
residual path carries them unchanged), the experts run as grouped
products, and the results are combined by the top-k gates.  The JAX
package vmaps over groups; the port loops over them.  Ties among the
router logits go to the lower expert index, as in ``jax.lax.top_k``
(:func:`top_k`).  The group axis carries the JAX package's two sharding
constraints (``constrain``, "moe_capacity"; a no-op on one card).  Covers
both assigned MoE archs:
llama4-scout (16e top-1) and granite-moe (32e top-8).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..distributed.sharding import constrain
from .config import ModelConfig
from .layers import dot, promote, silu
from .spec import ParamSpec


def moe_spec(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff
    return {
        "router": ParamSpec((d, E), ("embed", "experts"), init_scale=0.02),
        "w_gate": ParamSpec((E, d, ff), ("experts", "embed", "ffn")),
        "w_up": ParamSpec((E, d, ff), ("experts", "embed", "ffn")),
        "w_down": ParamSpec((E, ff, d), ("experts", "ffn", "embed")),
    }


def capacity(tokens: int, cfg: ModelConfig) -> int:
    c = int(math.ceil(tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    return max(8, -(-c // 8) * 8)  # round up to 8, as the JAX package does


def top_k(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest, descending, the
    lower index first among equal values (a stable sort; ``torch.topk``
    leaves ties in no stated order, and router logits rounded to bf16 tie
    often)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _experts(buf: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """SwiGLU of every expert over its (C, d) rows: (E, C, d)."""
    g = torch.einsum("ecd,edf->ecf", *promote(buf, w_gate))
    u = torch.einsum("ecd,edf->ecf", *promote(buf, w_up))
    return torch.einsum("ecf,efd->ecd", *promote(silu(g) * u, w_down))


def _dispatch_one_group(
    xf: torch.Tensor,  # (Tg, d) — one group's tokens
    router: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
    cfg: ModelConfig, C: int, first_expert: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-based dispatch + expert SwiGLU + combine for one token group.

    ``w_*`` hold experts ``first_expert`` onward (all of them by default);
    an assignment to any other expert is left out, so the output is these
    experts' share of the combine (expert parallelism sums the shares).
    Every shape is static: assignments past an expert's capacity, and to
    experts held elsewhere, are written to a spare row of the buffer and
    never read back."""
    T, d = xf.shape
    E, k = cfg.n_experts, cfg.top_k
    El = w_gate.shape[0]

    logits = dot(xf, router).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, sel = top_k(logits, k)  # (Tg, k)
    gates = torch.softmax(gate_vals, dim=-1)

    # Load-balancing auxiliary loss (Switch Transformer eq. 4), per group.
    me = torch.mean(probs, dim=0)
    ce = torch.mean(F.one_hot(sel[:, 0], E).float(), dim=0)
    aux = E * torch.sum(me * ce) * cfg.router_aux_coef

    N = T * k
    flat_e = sel.reshape(N) - first_expert
    mine = (flat_e >= 0) & (flat_e < El)
    flat_e = torch.where(mine, flat_e, torch.full_like(flat_e, El))  # held elsewhere: last
    sort_idx = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[sort_idx]
    counts = torch.zeros(El + 1, dtype=flat_e.dtype, device=xf.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(N, device=xf.device) - starts[sorted_e]
    keep = (pos_in_e < C) & (sorted_e < El)
    buf_slot = torch.where(keep, sorted_e * C + pos_in_e, torch.full_like(sorted_e, El * C))
    tok_of_sorted = sort_idx // k

    x_sorted = xf[tok_of_sorted]  # (N, d) local gather
    buf = torch.zeros((El * C + 1, d), dtype=xf.dtype, device=xf.device)
    buf[buf_slot] = x_sorted  # overflow and other experts' rows: the spare row
    y = _experts(buf[:El * C].reshape(El, C, d), w_gate, w_up, w_down).reshape(El * C, d)

    y_sorted = y[buf_slot.clamp(0, El * C - 1)]
    y_sorted = torch.where(keep[:, None], y_sorted, torch.zeros((), dtype=y.dtype,
                                                                device=y.device))
    y_assign = torch.zeros((N, d), dtype=xf.dtype, device=xf.device)
    y_assign[sort_idx] = y_sorted.to(xf.dtype)
    y_assign = y_assign.reshape(T, k, d)
    out = torch.sum(gates[..., None].to(xf.dtype) * y_assign, dim=1)
    return out, aux


def moe_block(x: torch.Tensor, p, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B,S,d), aux_loss scalar fp32).  ``cfg.moe_groups``
    (G) splits the tokens into groups dispatched independently, each with
    its own capacity (GShard semantics)."""
    B, S, d = x.shape
    T = B * S
    G = max(1, cfg.moe_groups)
    if T % G:
        raise ValueError(f"tokens {T} must divide moe_groups {G}")
    Tg = T // G
    C = capacity(Tg, cfg)
    x_pl = getattr(x, "placements", None)
    if x_pl is not None:  # the dry-run: only the batch stays sharded into groups
        from torch.distributed.tensor import Replicate, Shard

        x = x.redistribute(x.device_mesh, [p if isinstance(p, Shard) and p.dim == 0
                                           else Replicate() for p in x.placements])
    xg = constrain(x.reshape(G, Tg, d), ("moe_capacity", None, "act_embed"))
    if hasattr(xg, "device_mesh"):
        out, aux = _groups_on_shards(xg, p, cfg, C)
    else:
        out, aux = _groups(xg, p, cfg, C)
    out = constrain(out, ("moe_capacity", None, "act_embed")).reshape(B, S, d)
    if x_pl is not None:
        # back onto the block input's placements here: left to the residual
        # add, the gradient would come back in them through the reshape as
        # a strided shard of the groups, whose redistribution reads shard
        # offsets off a fake tensor
        out = out.redistribute(out.device_mesh, x_pl)
    return out, aux


def _groups(xg, p, cfg: ModelConfig, C: int, first_expert: int = 0, n_groups=None):
    """Every group of ``xg`` (G, Tg, d) dispatched on its own: (out (G, Tg,
    d), the groups' aux losses summed over ``n_groups``, their mean by
    default)."""
    outs, auxes = [], []
    for one in xg:
        out, aux = _dispatch_one_group(one, p["router"], p["w_gate"], p["w_up"],
                                       p["w_down"], cfg, C, first_expert)
        outs.append(out)
        auxes.append(aux)
    auxes = torch.stack(auxes)
    return torch.stack(outs), torch.mean(auxes) if n_groups is None else auxes.sum() / n_groups


def _groups_on_shards(xg, p, cfg: ModelConfig, C: int):
    """The groups on each device's shards (the dry-run): a device
    dispatches its own groups (``moe_capacity`` sharded) to its own experts
    (``experts`` sharded), and the shares of the output are summed over the
    experts' mesh axes (a partial sum there); the aux loss is each group's,
    averaged over all groups."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from .route import run_on_shards

    mesh = xg.device_mesh
    x_pl, w_pl, out_pl, aux_pl = [], [], [], []
    group_axes, expert_axes = [], []
    for axis, (px, pw) in enumerate(zip(xg.placements, p["w_gate"].placements)):
        if isinstance(px, Shard) and px.dim == 0:
            x_pl.append(Shard(0)), w_pl.append(Replicate())
            out_pl.append(Shard(0)), aux_pl.append(Partial())
            group_axes.append(axis)
        elif isinstance(pw, Shard) and pw.dim == 0:
            x_pl.append(Replicate()), w_pl.append(Shard(0))
            out_pl.append(Partial()), aux_pl.append(Replicate())
            expert_axes.append(axis)
        else:
            for pls in (x_pl, w_pl, out_pl, aux_pl):
                pls.append(Replicate())
    G = xg.shape[0]

    def local(xg, router, w_gate, w_up, w_down):
        part = 0
        for a in expert_axes:
            part = part * mesh.size(a) + mesh.get_local_rank(a)
        weights = {"router": router, "w_gate": w_gate, "w_up": w_up, "w_down": w_down}
        return _groups(xg, weights, cfg, C, part * w_gate.shape[0], n_groups=G)

    rep = (Replicate(),) * mesh.ndim
    return run_on_shards(local, (xg, p["router"], p["w_gate"], p["w_up"], p["w_down"]),
                         (tuple(x_pl), rep) + (tuple(w_pl),) * 3, (tuple(out_pl), tuple(aux_pl)))


def moe_block_dense_oracle(x: torch.Tensor, p, cfg: ModelConfig) -> torch.Tensor:
    """O(T·E·d·ff) dense oracle: every expert on every token, combined by
    the same top-k gates (exact in the no-drop regime)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    xf = x.reshape(-1, d)
    logits = dot(xf, p["router"]).float()
    gate_vals, sel = top_k(logits, k)
    gates = torch.softmax(gate_vals, dim=-1)
    g = torch.einsum("td,edf->tef", *promote(xf, p["w_gate"]))
    u = torch.einsum("td,edf->tef", *promote(xf, p["w_up"]))
    y_all = torch.einsum("tef,efd->ted", *promote(silu(g) * u, p["w_down"]))
    mask = F.one_hot(sel, E).float()  # (T, k, E)
    comb = torch.einsum("tke,tk->te", mask, gates)
    out = torch.einsum("te,ted->td", *promote(comb.to(x.dtype), y_all))
    return out.reshape(B, S, d)
