"""Mixture-of-Experts block with sort-based, capacity-bounded dispatch.

The port of ``repro.models.moe``: GShard-style groups, each dispatched on
its own with a per-group capacity; token→expert assignments are sorted
into a dense ``(E, C, d)`` buffer (capacity overflow drops tokens, whose
residual path carries them unchanged), the experts run as grouped
products, and the results are combined by the top-k gates.  The JAX
package vmaps over groups; the port loops over them.  Ties among the
router logits go to the lower expert index, as in ``jax.lax.top_k``
(:func:`top_k`).  Covers both assigned MoE archs:
llama4-scout (16e top-1) and granite-moe (32e top-8).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

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
    cfg: ModelConfig, C: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-based dispatch + expert SwiGLU + combine for one token group."""
    T, d = xf.shape
    E, k = cfg.n_experts, cfg.top_k

    logits = dot(xf, router).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, sel = top_k(logits, k)  # (Tg, k)
    gates = torch.softmax(gate_vals, dim=-1)

    # Load-balancing auxiliary loss (Switch Transformer eq. 4), per group.
    me = torch.mean(probs, dim=0)
    ce = torch.mean(F.one_hot(sel[:, 0], E).float(), dim=0)
    aux = E * torch.sum(me * ce) * cfg.router_aux_coef

    N = T * k
    flat_e = sel.reshape(N)
    sort_idx = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[sort_idx]
    counts = torch.bincount(flat_e, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(N, device=xf.device) - starts[sorted_e]
    keep = pos_in_e < C
    buf_slot = sorted_e * C + pos_in_e
    tok_of_sorted = sort_idx // k

    x_sorted = xf[tok_of_sorted]  # (N, d) local gather
    buf = torch.zeros((E * C, d), dtype=xf.dtype, device=xf.device)
    buf[buf_slot[keep]] = x_sorted[keep]  # overflow dropped
    y = _experts(buf.reshape(E, C, d), w_gate, w_up, w_down).reshape(E * C, d)

    y_sorted = y[buf_slot.clamp(0, E * C - 1)]
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
    outs, auxes = [], []
    for one in x.reshape(G, Tg, d):
        out, aux = _dispatch_one_group(one, p["router"], p["w_gate"], p["w_up"],
                                       p["w_down"], cfg, C)
        outs.append(out)
        auxes.append(aux)
    return torch.stack(outs).reshape(B, S, d), torch.mean(torch.stack(auxes))


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
