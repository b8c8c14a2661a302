"""RG-LRU recurrent block (RecurrentGemma / Griffin).

The port of ``repro.models.rglru``.  Recurrence (Griffin §2.4, c = 8)::

    r_t = σ(W_a x_t + b_a)                 recurrence gate
    i_t = σ(W_x x_t + b_x)                 input gate
    log a_t = -c · r_t · softplus(-Λ)      (a = σ(Λ)^(c·r_t), σ(Λ)∈[0.9,0.999])
    h_t = a_t ⊙ h_{t-1} + √(1 - a_t²) ⊙ (i_t ⊙ x_t)

The residual block is: RMSNorm → {conv1d(4) → RG-LRU} ⊙ GeLU(gate branch)
→ out-proj.  The recurrence goes to the port's ``rglru_scan``
(:func:`lru_scan`): on CUDA tensors the hand-written kernel through
``autotuned("rglru_scan")``, on CPU tensors its plain version.  Its inputs
are float32 (r and i are float32 in the JAX block, x_t is cast to float32
in its step, bf16 to float32 being exact), so its y is h itself at every
step, and ``y[:, -1]`` is the JAX block's final float32 state.  Where
autograd wants a gradient of the recurrence on CUDA tensors it runs
:class:`LruScanFn`: the forward kernel, and the backward kernel
(``autotuned("rglru_scan_bwd")``) in place of XLA's derivative of the JAX
``lax.scan``; on CPU tensors autograd runs through the plain version.
Decode (one token) stays in torch ops, as in the JAX package.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..kernels.rglru_scan import rglru_scan as rg_mod
from .config import ModelConfig
from .layers import dot, gelu, promote, sigmoid
from .route import (
    in_this_context, needs_grad, on_kernel, on_stand_in, rglru_bwd_stand_in, rglru_stand_in,
    run_kernel, run_on_shards, scan_placements,
)
from .spec import ParamSpec
from .ssm import _causal_conv1d, conv_tail

C_FACTOR = 8.0


def rglru_spec(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, w, K = cfg.d_model, cfg.lru_width_, cfg.d_conv
    return {
        "in_x": ParamSpec((d, w), ("embed", "rnn")),
        "in_gate": ParamSpec((d, w), ("embed", "rnn")),
        "conv_w": ParamSpec((K, w), ("conv", "rnn")),
        "conv_b": ParamSpec((w,), ("rnn",), init="zeros"),
        "wa": ParamSpec((w, w), ("rnn", "rnn")),
        "ba": ParamSpec((w,), ("rnn",), init="zeros"),
        "wx": ParamSpec((w, w), ("rnn", "rnn")),
        "bx": ParamSpec((w,), ("rnn",), init="zeros"),
        "lam": ParamSpec((w,), ("rnn",), init="rglru_lambda"),
        "out": ParamSpec((w, d), ("rnn", "embed")),
    }


def _rglru_gates(x: torch.Tensor, p) -> Tuple[torch.Tensor, torch.Tensor]:
    r = sigmoid(dot(x, p["wa"]).float() + p["ba"])
    i = sigmoid(dot(x, p["wx"]).float() + p["bx"])
    return r, i


def lru_scan(xs: torch.Tensor, r: torch.Tensor, i: torch.Tensor, lam: torch.Tensor):
    """The recurrence over float32 (B, S, w) x, r, i and (w,) Λ: h at every
    step, (B, S, w) float32."""
    args = tuple(t.float().contiguous() for t in (xs, r, i, lam))
    if on_stand_in(xs):
        return _stand_in(args)
    if on_kernel(xs):
        if needs_grad(*args):
            return LruScanFn.apply(*args, kernel_forward, in_this_context(kernel_backward))
        return run_kernel("rglru_scan", *args)
    rg_mod.counter.ran_plain()
    return rg_mod.rglru_scan_plain(*args)


def _stand_in(args):
    """The dry-run's recurrence (:func:`.route.on_stand_in`): the kernels'
    shape-only stand-ins through :class:`LruScanFn`, on each device's
    shards of DTensor operands."""

    def local(x, r, i, lam):
        if needs_grad(x, r, i, lam):
            return LruScanFn.apply(x, r, i, lam, rglru_stand_in,
                                   in_this_context(rglru_bwd_stand_in))
        return rglru_stand_in(x, r, i, lam)

    if not hasattr(args[0], "device_mesh"):  # not a DTensor
        return local(*args)
    pl = scan_placements(args[0], {"x": (0, 2), "lam": (None, 0)})
    return run_on_shards(local, args, (pl["x"],) * 3 + (pl["lam"],), pl["x"])


def kernel_forward(x, r, i, lam):
    """h at every step from the forward kernel, tuned per shape class."""
    return run_kernel("rglru_scan", x, r, i, lam)


def kernel_backward(x, r, i, lam, dy):
    """(dx, dr, di, dlam) from the backward kernel, tuned per shape class."""
    return run_kernel("rglru_scan_bwd", x, r, i, lam, dy)


class LruScanFn(torch.autograd.Function):
    """The RG-LRU recurrence whose backward recomputes h (in float32) from
    what the forward saves, its inputs, as XLA's derivative of the JAX
    ``lax.scan`` does from its residuals.  ``forward_fn(x, r, i, lam)``
    returns h at every step and ``backward_fn(x, r, i, lam, dy)`` the four
    gradients: the kernels (:func:`kernel_forward`, :func:`kernel_backward`)
    or their plain versions (``rglru_scan_plain``, ``rglru_scan_bwd_plain``)."""

    @staticmethod
    def forward(ctx, x, r, i, lam, forward_fn, backward_fn):
        y = forward_fn(x, r, i, lam)
        ctx.save_for_backward(x, r, i, lam)
        ctx.backward_fn = backward_fn
        return y

    @staticmethod
    def backward(ctx, dy):
        x, r, i, lam = ctx.saved_tensors
        return (*ctx.backward_fn(x, r, i, lam, dy.contiguous()), None, None)


def _rglru(x: torch.Tensor, p, cfg: ModelConfig):
    gate = gelu(dot(x, p["in_gate"]).float()).to(x.dtype)
    xs_raw = dot(x, p["in_x"])
    xs = _causal_conv1d(xs_raw, p["conv_w"], p["conv_b"])
    r, i = _rglru_gates(xs, p)  # (B,S,w) fp32
    hs = lru_scan(xs, r, i, p["lam"])
    y = hs.to(xs.dtype) * gate
    return dot(y, p["out"]), xs_raw, hs[:, -1]


def rglru_block(x: torch.Tensor, p, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d)."""
    return _rglru(x, p, cfg)[0]


def rglru_block_with_state(x: torch.Tensor, p, cfg: ModelConfig):
    """:func:`rglru_block` that also returns the final (conv window, h)
    state (``repro.models.transformer._rglru_block_with_state``)."""
    out, xs_raw, h = _rglru(x, p, cfg)
    return out, {"conv": conv_tail(xs_raw, cfg.d_conv), "h": h.contiguous()}


# ---------------------------------------------------------------------------
# Decode path
# ---------------------------------------------------------------------------


def rglru_init_cache(cfg: ModelConfig, batch: int, device="cuda") -> Dict[str, torch.Tensor]:
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.lru_width_), dtype=torch.bfloat16,
                            device=device),
        "h": torch.zeros((batch, cfg.lru_width_), dtype=torch.float32, device=device),
    }


def rglru_decode_step(
    x: torch.Tensor,  # (B, 1, d)
    cache: Dict[str, torch.Tensor], p, cfg: ModelConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    gate = gelu(dot(x, p["in_gate"]).float()).to(x.dtype)[:, 0]
    xs = dot(x, p["in_x"])[:, 0]  # (B, w)
    window = torch.cat([cache["conv"].to(xs.dtype), xs[:, None, :]], dim=1)
    xc = torch.einsum("bkw,kw->bw", *promote(window, p["conv_w"])) + p["conv_b"]

    r, i = _rglru_gates(xc, p)
    log_a = -C_FACTOR * r * F.softplus(-p["lam"].float())
    a = torch.exp(log_a)
    h = a * cache["h"] + torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xc.float())
    y = h.to(x.dtype) * gate
    out = dot(y, p["out"])[:, None, :]
    return out, {"conv": window[:, 1:, :].to(torch.bfloat16), "h": h}
