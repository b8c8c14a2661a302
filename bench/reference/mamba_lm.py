"""A Mamba-1 LM (falcon-mamba-7b's blocks) in plain float32 PyTorch: run
forward over whole sequences with its logits read at chosen positions
(:func:`logits_at`, serving), and its loss (:func:`loss`, training through
:func:`reference.training.follow`); :func:`layout` is its weight tree.

Per layer: x += block(rmsnorm(x)), where block is, for x (S, d)::

    xs, z = split(x @ in_proj)                     # (S, d_inner) each
    xs = silu(causal depthwise conv(xs) + conv_b)  # K taps, zero history
    dt, B, C = split(xs @ x_proj)                  # dt_rank, N, N
    dt = softplus(dt @ dt_w + dt_b);  A = -exp(A_log)
    h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t;  y_t = C_t . h_t + D x_t
    out = (y * silu(z)) @ out_proj

The recurrence runs as a scan in chunks (:func:`scan`): within a chunk the
states come from cumulative sums of the log-decay, anchored at the chunk's
middle, and the chunks are joined by a parallel prefix over their (decay,
state) pairs.  A step's log-decay is taken as at least ``-STEEPEST``: what
a steeper step carries over is below exp(-20) = 2e-9 of the state, under
float32's rounding of the new state's sum, and half a chunk then decays by
at most 80, so every exp stays finite.  :func:`logits_at` runs layer by
layer over all the sequences at once, a layer's weights taken to float32
only while it runs, so 64 layers of a 7B model and tens of thousands of
tokens fit the card.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import kept, rmsnorm, silu

CHUNK = 8
BLOCK = 1024      # steps whose (S, d_inner, N) terms are held at once
STEEPEST = 20.0   # CHUNK / 2 * STEEPEST = 80: exp() stays finite in float32


def layout(m: Dict[str, Any]) -> List[Tuple[Tuple, Tuple[int, ...]]]:
    """``(path, shape)`` of every leaf of the weight tree, in draw order."""
    d, V = m["d_model"], m["vocab_size"]
    di, N, R, K = m["d_inner"], m["ssm_state"], m["dt_rank"], m["d_conv"]
    leaves = [(("embed",), (V, d)), (("final_norm",), (d,))]
    if not m.get("tie_embeddings"):
        leaves.append((("unembed",), (d, V)))
    for i in range(m["n_layers"]):
        leaves += [
            (("layers", i, "ln"), (d,)),
            (("layers", i, "ssm", "in_proj"), (d, 2 * di)),
            (("layers", i, "ssm", "conv_w"), (K, di)),
            (("layers", i, "ssm", "conv_b"), (di,)),
            (("layers", i, "ssm", "x_proj"), (di, R + 2 * N)),
            (("layers", i, "ssm", "dt_w"), (R, di)),
            (("layers", i, "ssm", "dt_b"), (di,)),
            (("layers", i, "ssm", "A_log"), (di, N)),
            (("layers", i, "ssm", "D"), (di,)),
            (("layers", i, "ssm", "out_proj"), (di, d)),
        ]
    return leaves


def scan_steps(x, dt, A, B, C, h):
    """The recurrence one step at a time, exactly (what the tests hold the
    chunked scan to)."""
    ys = []
    for t in range(x.shape[0]):
        h = torch.exp(dt[t][:, None] * A) * h + (dt[t] * x[t])[:, None] * B[t][None, :]
        ys.append(h @ C[t])
    return torch.stack(ys), h


def _scan_block(x, dt, A, B, C, h0):
    """y (S, D) and the last state of the recurrence over one block of
    steps from state ``h0`` (D, N)."""
    S, D = x.shape
    T = CHUNK
    dA = (dt[:, :, None] * A).clamp(min=-STEEPEST)                      # (S, D, N), <= 0
    pad = -S % T
    if pad:  # identity steps: no decay (dt = 0), no input
        x, dt = F.pad(x, (0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
        B, C = F.pad(B, (0, 0, 0, pad)), F.pad(C, (0, 0, 0, pad))
        dA = F.pad(dA, (0, 0, 0, 0, 0, pad))
    n = x.shape[0] // T
    cum = dA.reshape(n, T, D, -1).cumsum(1)                             # log-decay from chunk start
    del dA
    mid = cum[:, T // 2 - 1:T // 2]                                     # anchor: keeps exps finite
    w = torch.exp(mid - cum) * (dt * x).reshape(n, T, D, 1) * B.reshape(n, T, 1, -1)
    w = w.cumsum(1) * torch.exp(cum - mid)                              # chunk-local states
    # join the chunks: state at the end of chunk c = a_c * (state before) + b_c
    a, b = torch.exp(cum[:, -1]), w[:, -1]
    shift = 1
    while shift < n:  # inclusive parallel prefix of the affine maps
        b = torch.cat([b[:shift], a[shift:] * b[:-shift] + b[shift:]])
        a = torch.cat([a[:shift], a[shift:] * a[:-shift]])
        shift *= 2
    ends = b + a * h0
    starts = torch.cat([h0[None], ends[:-1]])                           # (n, D, N)
    w = w + torch.exp(cum) * starts[:, None]                            # full states
    y = torch.einsum("ctdn,ctn->ctd", w, C.reshape(n, T, -1)).reshape(n * T, D)
    return y[:S], ends[-1]


def scan(x, dt, A, B, C) -> torch.Tensor:
    """y (S, D) of the recurrence over x, dt (S, D), A (D, N), B, C (S, N),
    from a zero state, without the D skip term."""
    h = torch.zeros(A.shape, dtype=torch.float32, device=x.device)
    ys = []
    for s0 in range(0, x.shape[0], BLOCK):
        s1 = min(x.shape[0], s0 + BLOCK)
        y, h = _scan_block(x[s0:s1], dt[s0:s1], A, B[s0:s1], C[s0:s1], h)
        ys.append(y)
    return torch.cat(ys)


def block(h: torch.Tensor, w: Dict[str, torch.Tensor], m: Dict[str, Any], mm: Callable,
          keep: Callable = kept):
    """One Mamba block over h (S, d), float32 weights ``w``.  ``keep``
    rounds each activation a served model stores (the configuration keeps
    them in bfloat16; float32 here, the control's 8-bit floats)."""
    S = h.shape[0]
    di, N, R, K = m["d_inner"], m["ssm_state"], m["dt_rank"], m["d_conv"]
    xz = keep(mm(h, w["in_proj"]))
    xs, z = xz[:, :di], xz[:, di:]
    xp = F.pad(xs, (0, 0, K - 1, 0))
    conv = sum(xp[k:k + S] * w["conv_w"][k] for k in range(K)) + w["conv_b"]
    xs = keep(silu(keep(conv)))
    raw = keep(mm(xs, w["x_proj"]))
    dt = F.softplus(keep(mm(raw[:, :R], w["dt_w"])) + w["dt_b"])
    y = keep(scan(xs, dt, -torch.exp(w["A_log"]), raw[:, R:R + N], raw[:, R + N:]))
    y = keep(keep(y + keep(xs * w["D"])) * keep(silu(z)))
    return keep(mm(y, w["out_proj"]))


def logits_at(weights, m: Dict[str, Any], seqs: Sequence[torch.Tensor],
              positions: Sequence[torch.Tensor], mm: Callable,
              keep: Callable = kept) -> List[torch.Tensor]:
    """Logits (len(positions[i]), vocab) of each sequence ``seqs[i]`` (token
    ids) at ``positions[i]``; ``weights`` is the model's tree (any float
    dtype), read a layer at a time in float32; ``keep`` as :func:`block`
    takes it."""
    with torch.no_grad():
        emb = weights["embed"]
        xs = [keep(emb[s].float()) for s in seqs]
        eps = m["norm_eps"]
        for lp in weights["layers"]:
            w = {k: v.float() for k, v in lp["ssm"].items()}
            ln = lp["ln"].float()
            xs = [keep(x + block(keep(rmsnorm(x, ln, eps)), w, m, mm, keep)) for x in xs]
            del w
        head = _head(weights).float()
        fn = weights["final_norm"].float()
        return [keep(mm(keep(rmsnorm(x[p], fn, eps)), head)) for x, p in zip(xs, positions)]


def _head(params) -> torch.Tensor:
    return params["unembed"] if "unembed" in params else params["embed"].T


def loss(params, tokens: torch.Tensor, targets: torch.Tensor, m: Dict[str, Any],
         mm: Callable) -> torch.Tensor:
    """Mean next-token cross-entropy over tokens (B, S) of float32
    ``params``; each layer, and the head, recomputed in the backward."""
    eps = m["norm_eps"]
    x = params["embed"][tokens]

    def one(x, p):
        return torch.stack([r + block(rmsnorm(r, p["ln"], eps), p["ssm"], m, mm) for r in x])

    for p in params["layers"]:
        x = checkpoint(one, x, p, use_reentrant=False)

    def head(x):
        logits = mm(rmsnorm(x, params["final_norm"], eps), _head(params))
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1).long())

    return checkpoint(head, x, use_reentrant=False)
