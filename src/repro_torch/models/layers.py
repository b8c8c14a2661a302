"""Shared layer primitives: norms, RoPE (incl. M-RoPE), MLPs, embeddings.

The port of ``repro.models.layers``.  Numerics policy (uniform across the
zoo, as in the JAX package): parameters bf16, activations bf16, norm
statistics and RoPE tables fp32, logits and losses fp32.  Where the JAX
package mixes dtypes in one product (a bf16 activation against a float32
weight, which the tests' float32-cast weights give), :func:`dot` promotes
both as JAX does, since torch's matmul takes one dtype.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .spec import ParamSpec


def promote(*ts: torch.Tensor):
    """The tensors cast to their common dtype (JAX's promotion of float
    dtypes: bf16 with float32 gives float32)."""
    dtype = functools.reduce(torch.promote_types, (t.dtype for t in ts))
    return [t if t.dtype == dtype else t.to(dtype) for t in ts]


def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("...d,d...->......", x, w)``: x's last axis against w's
    first, the product in the promoted dtype."""
    x, w = promote(x, w)
    if hasattr(x, "device_mesh") or hasattr(w, "device_mesh"):
        return _dot_on_shards(x, w)
    out = x @ w.reshape(w.shape[0], -1)
    return out.reshape(x.shape[:-1] + w.shape[1:])


def _dot_on_shards(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """:func:`dot` of DTensors (the dry-run) on each device's shards, per
    mesh axis as XLA's partitioner runs a sharded product: x's leading dims
    (batch, sequence) stay sharded against a replicated w; w's output dims
    stay sharded against a replicated x (tensor parallel); a contraction
    sharded on either side is sharded on both, its sum all-reduced after;
    where x's batch and any dim of w share an axis, w is gathered (FSDP),
    and where x's sequence and w's output dims do, x is (a sequence shard
    before a column-parallel product).  The gradient of an
    operand replicated against the other's shards is a partial sum."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from .route import run_on_shards

    mesh = (x if isinstance(x, DTensor) else w).device_mesh
    x = resolve_partial(x) if isinstance(x, DTensor) else x
    w = resolve_partial(w) if isinstance(w, DTensor) else w
    rep = (Replicate(),) * mesh.ndim
    xp = x.placements if isinstance(x, DTensor) else rep
    wp = w.placements if isinstance(w, DTensor) else rep
    lead = x.dim() - 1
    x_pl, w_pl, out_pl, x_grad, w_grad = [], [], [], [], []
    for px, pw in zip(xp, wp):
        x_lead = isinstance(px, Shard) and px.dim < lead
        x_contract = isinstance(px, Shard) and px.dim == lead
        w_contract = isinstance(pw, Shard) and pw.dim == 0
        w_out = isinstance(pw, Shard) and pw.dim > 0
        if x_lead and (px.dim == 0 or not w_out):  # data parallel; FSDP gathers w
            x_pl.append(px), w_pl.append(Replicate()), out_pl.append(px)
            x_grad.append(px), w_grad.append(Partial())
        elif w_out:  # tensor parallel over w's output dims (x gathered)
            x_pl.append(Replicate()), w_pl.append(pw), out_pl.append(Shard(lead + pw.dim - 1))
            x_grad.append(Partial()), w_grad.append(pw)
        elif x_contract or w_contract:  # row parallel: a partial sum
            x_pl.append(Shard(lead)), w_pl.append(Shard(0)), out_pl.append(Partial())
            x_grad.append(Shard(lead)), w_grad.append(Shard(0))
        else:
            for pls in (x_pl, w_pl, out_pl, x_grad, w_grad):
                pls.append(Replicate())

    def local(x, w):
        out = x @ w.reshape(w.shape[0], -1)
        return out.reshape(x.shape[:-1] + w.shape[1:])

    out = run_on_shards(local, (x, w), (tuple(x_pl), tuple(w_pl)), tuple(out_pl),
                        grad_placements=(tuple(x_grad), tuple(w_grad)))
    return resolve_partial(out)


def resolve_partial(t: torch.Tensor) -> torch.Tensor:
    """A DTensor whose placements hold a partial sum (a product contracted
    over a sharded axis, in the dry-run) with the sum all-reduced, as XLA's
    partitioner reduces a row-parallel product; any other tensor as it is."""
    placements = getattr(t, "placements", None)
    if placements is None:
        return t
    from torch.distributed.tensor import Partial, Replicate

    if not any(isinstance(p, Partial) for p in placements):
        return t
    return t.redistribute(t.device_mesh, [Replicate() if isinstance(p, Partial) else p
                                          for p in placements])


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_spec(d: int) -> ParamSpec:
    return ParamSpec((d,), ("embed",), init="ones")


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * w.float()).to(x.dtype)


def layernorm_spec(d: int) -> Dict[str, ParamSpec]:
    return {
        "scale": ParamSpec((d,), ("embed",), init="ones"),
        "bias": ParamSpec((d,), ("embed",), init="zeros"),
    }


def layernorm(x: torch.Tensor, p, eps: float) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE — standard and multimodal (M-RoPE, Qwen2-VL §3.1)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies, fp32."""
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """The half-split rotation of ``repro.models.layers.rope_apply``:
    (x1, x2) -> (x1 cos - x2 sin, x2 cos + x1 sin) on the two halves of the
    head dim, in fp32, cast back to x's dtype.  ``ang``: (..., seq, half)."""
    half = x.shape[-1] // 2
    cos = torch.cos(ang)[..., None, :]  # (..., seq, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope_apply(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate ``x`` (..., seq, heads, head_dim) by ``positions`` (..., seq)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # (half,)
    return _rotate(x, positions.float()[..., None] * freqs)


def mrope_apply(
    x: torch.Tensor,
    positions: torch.Tensor,  # (3, ..., seq) — temporal / height / width ids
    theta: float,
    sections: Tuple[int, int, int],
) -> torch.Tensor:
    """Multimodal RoPE: head_dim/2 frequency slots split across t/h/w
    position streams (Qwen2-VL).  For pure-text tokens the three ids
    coincide and M-RoPE degenerates to standard RoPE."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {sections} do not sum to head_dim/2 = {half}")
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # (half,)
    sec_id = torch.tensor([i for i, n in enumerate(sections) for _ in range(n)],
                          device=x.device)
    pos_per_slot = positions.float()[sec_id]  # (half, ..., seq)
    ang = torch.movedim(pos_per_slot, 0, -1) * freqs  # (..., seq, half)
    return _rotate(x, ang)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def swiglu_spec(d: int, ff: int) -> Dict[str, ParamSpec]:
    return {
        "w_gate": ParamSpec((d, ff), ("embed", "ffn")),
        "w_up": ParamSpec((d, ff), ("embed", "ffn")),
        "w_down": ParamSpec((ff, d), ("ffn", "embed")),
    }


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as XLA expands it: ``1 / (1 + exp(-x))``, each
    operation rounded to x's dtype (``torch.sigmoid`` rounds once, and on
    bf16 falls one ulp away from JAX at a quarter of the inputs)."""
    return 1 / (1 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x times :func:`sigmoid` of x, rounded again."""
    return x * sigmoid(x)


def swiglu(x: torch.Tensor, p) -> torch.Tensor:
    g = dot(x, p["w_gate"])
    u = dot(x, p["w_up"])
    return dot(silu(g) * u, p["w_down"])


def gelu_mlp_spec(d: int, ff: int) -> Dict[str, ParamSpec]:
    return {
        "w_in": ParamSpec((d, ff), ("embed", "ffn")),
        "b_in": ParamSpec((ff,), ("ffn",), init="zeros"),
        "w_out": ParamSpec((ff, d), ("ffn", "embed")),
        "b_out": ParamSpec((d,), ("embed",), init="zeros"),
    }


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def gelu_mlp(x: torch.Tensor, p) -> torch.Tensor:
    h = dot(x, p["w_in"]) + p["b_in"]
    h = gelu(h.float()).to(x.dtype)
    return dot(h, p["w_out"]) + p["b_out"]


# ---------------------------------------------------------------------------
# Embeddings / unembedding
# ---------------------------------------------------------------------------


def embed_spec(cfg: ModelConfig) -> ParamSpec:
    return ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed_table"), init_scale=0.02)


def unembed_spec(cfg: ModelConfig) -> ParamSpec:
    return ParamSpec((cfg.d_model, cfg.vocab_size), ("embed_table", "vocab"))


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``; where a gradient is wanted, through
    :class:`Embed`, whose backward sums in a fixed order.  A DTensor table
    (the dry-run) is read on each device's shard of its rows
    (:func:`_embed_on_shards`)."""
    if hasattr(table, "device_mesh"):
        return _embed_on_shards(tokens, table)
    if torch.is_grad_enabled() and table.requires_grad:
        return Embed.apply(table, tokens)
    return table[tokens]


def _embed_on_shards(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The lookup on a DTensor table whose rows (the vocab) are sharded: each
    device reads the tokens among its own rows (zeros for the others) and
    the rows are summed over the vocab's mesh axes, as XLA's partitioner
    does; an index would gather the whole table.  The table's gradient
    stays on its shards."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from .route import run_on_shards

    mesh = table.device_mesh
    t_pl, tok_pl, out_pl, vocab_axes = [], [], [], []
    for axis, (pt, pk) in enumerate(zip(table.placements, tokens.placements)):
        if isinstance(pt, Shard) and pt.dim == 0:
            t_pl.append(pt), tok_pl.append(Replicate()), out_pl.append(Partial())
            vocab_axes.append(axis)
        elif isinstance(pk, Shard):
            t_pl.append(Replicate()), tok_pl.append(pk), out_pl.append(pk)
        else:
            t_pl.append(Replicate()), tok_pl.append(Replicate()), out_pl.append(Replicate())

    def local(tok, tab):
        part = 0
        for a in vocab_axes:
            part = part * mesh.size(a) + mesh.get_local_rank(a)
        idx = tok.long() - part * tab.shape[0]
        mine = (idx >= 0) & (idx < tab.shape[0])
        rows = F.embedding(idx.clamp(0, tab.shape[0] - 1), tab)
        return rows * mine[..., None].to(rows.dtype)

    out = run_on_shards(local, (tokens, table), (tuple(tok_pl), tuple(t_pl)), tuple(out_pl))
    return resolve_partial(out)


@contextlib.contextmanager
def deterministic_algorithms():
    """Inside, PyTorch takes its deterministic kernels; the setting before
    is restored after."""
    was = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn_only)


class Embed(torch.autograd.Function):
    """The embedding gather whose backward is deterministic.  Autograd's own
    backward of ``table[tokens]`` scatter-adds the rows of repeated tokens
    with atomics on the card, in an order that changes from run to run; this
    one runs the same ``index_put_(accumulate=True)`` under
    :func:`deterministic_algorithms`, where PyTorch sorts the indices and
    sums each token's rows in order.  So a training run's losses repeat bit
    for bit (the restart check)."""

    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.table_shape = table.shape
        return table[tokens]

    @staticmethod
    def backward(ctx, grad):
        (tokens,) = ctx.saved_tensors
        out = torch.zeros(ctx.table_shape, dtype=grad.dtype, device=grad.device)
        with deterministic_algorithms():
            out.index_put_((tokens,), grad, accumulate=True)
        return out, None


def unembed(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Logits in fp32 (loss numerics): the product in the activations'
    dtype, then cast, as ``repro.models.layers.unembed``."""
    return dot(x, w).float()
