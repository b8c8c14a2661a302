"""A decoder-only LM with grouped-query attention and a sparse
mixture-of-experts MLP (granite-moe-1b-a400m's blocks), its loss, and its
training steps under AdamW, in plain float32 PyTorch.

Per layer: x += attn(rmsnorm(x)); x += moe(rmsnorm(x)).  Attention is
causal, with rotary embedding on q and k and each KV head shared by
``n_heads / n_kv_heads`` query heads, scaled by 1/sqrt(head_dim).  The MoE
block routes each token to the ``top_k`` experts of largest router logit
(ties to the lower index), weighs them by the softmax of those logits, and
runs each expert's SwiGLU on at most ``capacity`` of its assignments, the
first in (token, rank) order; an assignment past capacity adds nothing.
``capacity`` is ceil(tokens * top_k / n_experts * capacity_factor), rounded
up to a multiple of 8 and at least 8.  The load-balancing loss (Switch
Transformer eq. 4: n_experts * sum(mean prob * share of first choices) *
coefficient) of each layer is added to the mean next-token cross-entropy.
Logits come from the tied embedding.

Each layer, and the loss head, is recomputed in the backward
(``torch.utils.checkpoint``), and attention runs a block of queries at a
time, so a B=4, S=4096 step fits the card in float32.

The entry points every reference module has: :func:`layout` (the weight
tree the benchmark draws), :func:`loss` (training, through
:func:`reference.training.follow`), :func:`logits_at` (serving) and
:func:`notes` (what a run prints beside its check).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import F32, kept, rmsnorm, rope, silu

Q_BLOCK = 1024


def layout(m: Dict[str, Any]) -> List[Tuple[Tuple, Tuple[int, ...]]]:
    """``(path, shape)`` of every leaf of the weight tree, in draw order."""
    d, V = m["d_model"], m["vocab_size"]
    H, KV, hd, E, ff = m["n_heads"], m["n_kv_heads"], m["head_dim"], m["n_experts"], m["d_ff"]
    leaves = [(("embed",), (V, d)), (("final_norm",), (d,))]
    if not m.get("tie_embeddings"):
        leaves.append((("unembed",), (d, V)))
    for i in range(m["n_layers"]):
        leaves += [
            (("layers", i, "ln1"), (d,)),
            (("layers", i, "attn", "wq"), (d, H, hd)),
            (("layers", i, "attn", "wk"), (d, KV, hd)),
            (("layers", i, "attn", "wv"), (d, KV, hd)),
            (("layers", i, "attn", "wo"), (H, hd, d)),
            (("layers", i, "ln2"), (d,)),
            (("layers", i, "moe", "router"), (d, E)),
            (("layers", i, "moe", "w_gate"), (E, d, ff)),
            (("layers", i, "moe", "w_up"), (E, d, ff)),
            (("layers", i, "moe", "w_down"), (E, ff, d)),
        ]
    return leaves


def capacity(tokens: int, m: Dict[str, Any]) -> int:
    c = int(math.ceil(tokens * m["top_k"] / m["n_experts"] * m["capacity_factor"]))
    return max(8, -(-c // 8) * 8)


def attention(q, k, v, mm: Callable) -> torch.Tensor:
    """Causal attention, q (B, S, H, hd), k, v (B, S, KV, hd)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd).permute(0, 2, 3, 1, 4)   # B KV G S hd
    kt = k.permute(0, 2, 3, 1)[:, :, None]                          # B KV 1 hd S
    vv = v.permute(0, 2, 1, 3)[:, :, None]                          # B KV 1 S hd
    outs = []
    for q0 in range(0, S, Q_BLOCK):
        q1 = min(S, q0 + Q_BLOCK)
        s = mm(qg[:, :, :, q0:q1], kt[..., :q1]) / math.sqrt(hd)
        mask = (torch.arange(q0, q1, device=q.device)[:, None]
                >= torch.arange(q1, device=q.device)[None, :])
        w = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        outs.append(mm(w, vv[:, :, :, :q1]))
    o = torch.cat(outs, dim=3)                                       # B KV G S hd
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)


def moe(h: torch.Tensor, p: Dict[str, torch.Tensor], m: Dict[str, Any], mm: Callable,
        tally: Optional[List] = None, dropless: bool = False):
    """(output (B, S, d), load-balancing loss) of the expert block; appends
    (assignments dropped past capacity, assignments) to ``tally`` where
    given.  ``dropless``: no capacity (tokens dispatched one at a time,
    which never fill one)."""
    B, S, d = h.shape
    E, k = m["n_experts"], m["top_k"]
    x = h.reshape(B * S, d)
    logits = mm(x, p["router"])
    probs = torch.softmax(logits, dim=-1)
    vals, sel = torch.sort(logits, dim=-1, descending=True, stable=True)
    vals, sel = vals[:, :k], sel[:, :k]
    gates = torch.softmax(vals, dim=-1)
    first = F.one_hot(sel[:, 0], E).float().mean(0)
    aux = E * torch.sum(probs.mean(0) * first) * m["router_aux_coef"]
    C = B * S * k if dropless else capacity(B * S, m)
    flat = sel.reshape(-1)                        # assignment a = token * k + rank
    if tally is not None:
        load = torch.bincount(flat, minlength=E)
        tally.append((int((load - C).clamp(min=0).sum()), flat.numel()))
    out = torch.zeros_like(x)
    for e in range(E):
        a = torch.nonzero(flat == e).squeeze(1)[:C]  # its first C, in (token, rank) order
        if a.numel() == 0:
            continue
        t, r = a // k, a % k
        xe = x[t]
        y = mm(silu(mm(xe, p["w_gate"][e])) * mm(xe, p["w_up"][e]), p["w_down"][e])
        out = out.index_add(0, t, gates[t, r][:, None] * y)
    return out.reshape(B, S, d), aux


def layer(x, p, m: Dict[str, Any], mm: Callable, keep: Callable = kept,
          tally: Optional[List] = None, prompt: Optional[int] = None):
    """One block over x (B, S, d); ``keep`` rounds each activation a served
    model stores (float32 here, the control's 8-bit floats).  With
    ``prompt``, the MoE block dispatches the first ``prompt`` tokens as a
    prefill does (one capacity over them) and each later token on its own,
    as a decode step of one sequence does."""
    B, S, d = x.shape
    eps, hd = m["norm_eps"], m["head_dim"]
    a = p["attn"]
    h = keep(rmsnorm(x, p["ln1"], eps))
    q = keep(rope(mm(h, a["wq"].reshape(d, -1)).reshape(B, S, -1, hd), m["rope_theta"]))
    kk = keep(rope(mm(h, a["wk"].reshape(d, -1)).reshape(B, S, -1, hd), m["rope_theta"]))
    v = keep(mm(h, a["wv"].reshape(d, -1)).reshape(B, S, -1, hd))
    o = keep(attention(q, kk, v, mm))
    x = keep(x + mm(o.reshape(B, S, -1), a["wo"].reshape(-1, d)))
    h = keep(rmsnorm(x, p["ln2"], eps))
    if prompt is None or prompt >= S:
        y, aux = moe(h, p["moe"], m, mm, tally)
    else:
        y, aux = moe(h[:, :prompt], p["moe"], m, mm, tally)
        y = torch.cat([y, moe(h[:, prompt:], p["moe"], m, mm, dropless=True)[0]], dim=1)
    return keep(x + keep(y)), aux


def _head(params) -> torch.Tensor:
    return params["unembed"] if "unembed" in params else params["embed"].T


def loss(params, tokens: torch.Tensor, targets: torch.Tensor, m: Dict[str, Any],
         mm: Callable) -> torch.Tensor:
    """Mean next-token cross-entropy plus every layer's load-balancing loss."""
    x = params["embed"][tokens]
    aux = torch.zeros((), device=x.device)
    for p in params["layers"]:
        x, a = checkpoint(lambda x, p=p: layer(x, p, m, mm), x, use_reentrant=False)
        aux = aux + a

    def head(x):
        logits = mm(rmsnorm(x, params["final_norm"], m["norm_eps"]), _head(params))
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1).long())

    return checkpoint(head, x, use_reentrant=False) + aux


def logits_at(weights, m: Dict[str, Any], seqs: Sequence[torch.Tensor],
              positions: Sequence[torch.Tensor], mm: Callable,
              keep: Callable = kept) -> List[torch.Tensor]:
    """Logits (len(positions[i]), vocab) of each sequence ``seqs[i]`` (token
    ids) at ``positions[i]``, each sequence served alone: its prompt, the
    tokens up to ``positions[i][0]``, prefilled (one MoE capacity over
    them), each later token decoded on its own; ``weights`` is the model's
    tree (any float dtype), read a layer at a time in float32."""
    with torch.no_grad():
        xs = [keep(weights["embed"][s].float()[None]) for s in seqs]
        prompts = [int(pos[0]) + 1 for pos in positions]
        for lp in weights["layers"]:
            p = {k: ({n: t.float() for n, t in v.items()} if isinstance(v, dict) else v.float())
                 for k, v in lp.items()}
            xs = [layer(x, p, m, mm, keep, prompt=n)[0] for x, n in zip(xs, prompts)]
            del p
        head, fn = _head(weights).float(), weights["final_norm"].float()
        return [keep(mm(keep(rmsnorm(x[0, pos], fn, m["norm_eps"])), head))
                for x, pos in zip(xs, positions)]


def notes(weights, batch: Dict[str, torch.Tensor], m: Dict[str, Any]) -> Dict[str, float]:
    """The share of the expert assignments dropped past capacity in a
    forward over ``batch``'s tokens on the float32 ``weights`` (over all
    layers, and at the layer that drops most)."""
    tally: List = []
    with torch.no_grad():
        x = weights["embed"][batch["tokens"]]
        for p in weights["layers"]:
            x, _ = layer(x, p, m, F32, tally=tally)
    dropped = sum(d for d, _ in tally)
    return {"dropped_share": dropped / sum(n for _, n in tally),
            "dropped_share_worst_layer": max(d / n for d, n in tally)}
