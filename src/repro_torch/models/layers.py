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
    out = x @ w.reshape(w.shape[0], -1)
    return out.reshape(x.shape[:-1] + w.shape[1:])


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
    sec_id = torch.repeat_interleave(
        torch.arange(3, device=x.device), torch.tensor(sections, device=x.device))
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
    :class:`Embed`, whose backward sums in a fixed order."""
    if torch.is_grad_enabled() and table.requires_grad:
        return Embed.apply(table, tokens)
    return table[tokens]


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
