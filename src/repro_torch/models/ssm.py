"""Mamba-1 selective SSM block (falcon-mamba-7b).

The port of ``repro.models.ssm``.  Recurrence (per channel c, state n)::

    h_t = exp(Δ_t A) ⊙ h_{t-1} + Δ_t B_t x_t
    y_t = C_t · h_t + D x_t

with input-dependent Δ (softplus), B, C.  The JAX block computes Δ, B_t
and C_t per step inside ``lax.scan`` in float32 (the (B, S, d_inner, N)
decay is never stored); the port computes them for all steps at once (the
same element-wise arithmetic) and hands the recurrence to the port's
``ssm_scan`` (:func:`selective_scan`): on CUDA tensors the hand-written
kernel through ``autotuned("ssm_scan")``, on CPU tensors its plain
version.  Its inputs are float32, as the JAX step casts x_t, Δ, B_t and
C_t (bf16 to float32 is exact), so the kernel's float32 instance computes
what the JAX step computes.  The kernel's skip term is given D = 0: the
JAX block rounds y to the activations' dtype first and adds ``xs * D``
there, which the port then does the same way.  Where autograd wants a
gradient of the recurrence on CUDA tensors it runs :class:`SelectiveScanFn`:
the forward kernel, and the backward kernel
(``autotuned("ssm_scan_bwd")``) in place of XLA's derivative of the JAX
``lax.scan``; on CPU tensors autograd runs through the plain version.
Decode (one token) stays in torch ops, as in the JAX package.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..kernels.ssm_scan import ssm_scan as ssm_mod
from .config import ModelConfig
from .layers import dot, promote, silu
from .route import (
    in_this_context, kernel_state, needs_grad, on_kernel, on_stand_in, run_kernel, run_on_shards,
    scan_placements, ssm_bwd_stand_in, ssm_stand_in,
)
from .spec import ParamSpec


def ssm_spec(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, di, N, R, K = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank_, cfg.d_conv
    return {
        "in_proj": ParamSpec((d, 2 * di), ("embed", "rnn")),
        "conv_w": ParamSpec((K, di), ("conv", "rnn")),
        "conv_b": ParamSpec((di,), ("rnn",), init="zeros"),
        "x_proj": ParamSpec((di, R + 2 * N), ("rnn", None)),
        "dt_w": ParamSpec((R, di), (None, "rnn")),
        "dt_b": ParamSpec((di,), ("rnn",), init_scale=0.02),
        "A_log": ParamSpec((di, N), ("rnn", "state"), init_scale=0.5),
        "D": ParamSpec((di,), ("rnn",), init="ones"),
        "out_proj": ParamSpec((di, d), ("rnn", "embed")),
    }


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over seq.  x: (B,S,di), w: (K,di); the taps
    added one at a time, as the JAX version does."""
    K = w.shape[0]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for k in range(K):
        out = out + xp[:, k:k + x.shape[1], :] * w[k]
    return out + b


def conv_tail(xs_raw: torch.Tensor, K: int) -> torch.Tensor:
    """Last K-1 pre-conv inputs as the decode conv state, zero-left-padded
    when the prompt is shorter than K-1 (the causal conv's implicit zeros)."""
    tail = xs_raw[:, max(0, xs_raw.shape[1] - (K - 1)):, :]
    short = (K - 1) - tail.shape[1]
    if short > 0:
        tail = F.pad(tail, (0, 0, short, 0))
    return tail.to(torch.bfloat16)


def selective_scan(xs, dt, A, Bt, Ct, final_state: bool = False):
    """The recurrence over float32 (B, S, di) x and Δ, (di, N) A and
    (B, S, N) B_t, C_t, with no skip term: y (B, S, di) float32, and with
    ``final_state`` also h after the last step (B, di, N) float32.  On
    CUDA tensors the kernel (through :class:`SelectiveScanFn` where a
    gradient is wanted), on CPU tensors the plain version."""
    skip = torch.zeros(xs.shape[-1], dtype=torch.float32, device=xs.device)
    args = tuple(t.contiguous() for t in (xs, dt, A, Bt, Ct, skip))
    if on_stand_in(xs):
        return _stand_in(args, final_state)
    if on_kernel(xs):
        if needs_grad(*args):
            return SelectiveScanFn.apply(*args, final_state, kernel_forward,
                                         in_this_context(kernel_backward))
        if not final_state:
            return run_kernel("ssm_scan", *args)
        return kernel_forward(*args, True)
    ssm_mod.counter.ran_plain()
    return ssm_mod.ssm_scan_plain(*args, final_state=final_state)


def _stand_in(args, final_state: bool):
    """The dry-run's scan (:func:`.route.on_stand_in`): the kernels'
    shape-only stand-ins through :class:`SelectiveScanFn`, on each device's
    shards of DTensor operands."""

    def local(x, dt, A, Bc, Cc, skip):
        if needs_grad(x, dt, A, Bc, Cc, skip):
            return SelectiveScanFn.apply(x, dt, A, Bc, Cc, skip, final_state, ssm_stand_in,
                                         in_this_context(ssm_bwd_stand_in))
        return ssm_stand_in(x, dt, A, Bc, Cc, skip, final_state)

    if not hasattr(args[0], "device_mesh"):  # not a DTensor
        return local(*args)
    pl = scan_placements(args[0], {"x": (0, 2), "A": (None, 0), "bc": (0, None),
                                   "h": (0, 1)})
    ins = (pl["x"], pl["x"], pl["A"], pl["bc"], pl["bc"], pl["A"])
    return run_on_shards(local, args, ins, (pl["x"], pl["h"]) if final_state else pl["x"])


def kernel_forward(x, dt, A, Bc, Cc, skip, final_state: bool):
    """y, or (y, h), from the forward kernel at the point its shape class
    tuned (or recalled): the class serving uses, so training pays no
    second tune."""
    point = kernel_state("ssm_scan", x, dt, A, Bc, Cc, skip).region.selected
    return ssm_mod.ssm_scan(x, dt, A, Bc, Cc, skip, **point, final_state=final_state)


def kernel_backward(x, dt, A, Bc, Cc, skip, dy, dh):
    """(dx, ddt, dA, dBc, dCc, dskip) from the backward kernel, tuned per
    shape class."""
    return run_kernel("ssm_scan_bwd", x, dt, A, Bc, Cc, skip, dy, dh)


class SelectiveScanFn(torch.autograd.Function):
    """The selective scan whose backward recomputes the states from what
    the forward saves, its inputs (O(S·d), no (S, d, N) state), as XLA's
    derivative of the JAX ``lax.scan`` does from its residuals.
    ``forward_fn(x, dt, A, Bc, Cc, skip, final_state)`` returns y, or
    ``(y, h)``; ``backward_fn(x, dt, A, Bc, Cc, skip, dy, dh)`` returns the
    six gradients: the kernels (:func:`kernel_forward`,
    :func:`kernel_backward`), or their plain versions (``ssm_scan_plain``,
    ``ssm_scan_bwd_plain``).  A gradient through
    the final state seeds the adjoint (``dh``; None where none flows)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bc, Cc, skip, final_state, forward_fn, backward_fn):
        ctx.set_materialize_grads(False)
        out = forward_fn(x, dt, A, Bc, Cc, skip, final_state)
        ctx.save_for_backward(x, dt, A, Bc, Cc, skip)
        ctx.backward_fn = backward_fn
        return out

    @staticmethod
    def backward(ctx, dy, dh=None):
        x, dt, A, Bc, Cc, skip = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        dh = None if dh is None else dh.contiguous()
        grads = ctx.backward_fn(x, dt, A, Bc, Cc, skip, dy, dh)
        return (*grads, None, None, None)


def _ssm(x: torch.Tensor, p, cfg: ModelConfig, final_state: bool):
    di, N, R = cfg.d_inner, cfg.ssm_state, cfg.dt_rank_
    xz = dot(x, p["in_proj"])
    xs_raw, z = xz[..., :di], xz[..., di:]  # (B,S,di) each
    xs = silu(_causal_conv1d(xs_raw, p["conv_w"], p["conv_b"]))
    A = -torch.exp(p["A_log"].float())  # (di, N)
    raw = dot(xs, p["x_proj"])  # (B,S,R+2N)
    dt = F.softplus(dot(raw[..., :R], p["dt_w"]).float() + p["dt_b"].float())
    B_t = raw[..., R:R + N].float()
    C_t = raw[..., R + N:].float()
    got = selective_scan(xs.float(), dt, A, B_t, C_t, final_state)
    ys, h = got if final_state else (got, None)
    y, xd = promote(ys.to(x.dtype), xs * p["D"])
    y = (y + xd) * silu(z)
    return dot(y, p["out_proj"]), xs_raw, h


def ssm_block(x: torch.Tensor, p, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d)."""
    return _ssm(x, p, cfg, final_state=False)[0]


def ssm_block_with_state(x: torch.Tensor, p, cfg: ModelConfig):
    """:func:`ssm_block` that also returns the final (conv window, h)
    state (``repro.models.transformer._ssm_block_with_state``)."""
    out, xs_raw, h = _ssm(x, p, cfg, final_state=True)
    return out, {"conv": conv_tail(xs_raw, cfg.d_conv), "h": h}


# ---------------------------------------------------------------------------
# Decode path (stateful, O(1) per token)
# ---------------------------------------------------------------------------


def ssm_init_cache(cfg: ModelConfig, batch: int, device="cuda") -> Dict[str, torch.Tensor]:
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner), dtype=torch.bfloat16,
                            device=device),
        "h": torch.zeros((batch, cfg.d_inner, cfg.ssm_state), dtype=torch.float32,
                         device=device),
    }


def ssm_decode_step(
    x: torch.Tensor,  # (B, 1, d)
    cache: Dict[str, torch.Tensor], p, cfg: ModelConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    di, N, R = cfg.d_inner, cfg.ssm_state, cfg.dt_rank_
    xz = dot(x, p["in_proj"])[:, 0]
    xs, z = xz[:, :di], xz[:, di:]  # (B, di)
    window = torch.cat([cache["conv"].to(xs.dtype), xs[:, None, :]], dim=1)
    conv_out = torch.einsum("bkd,kd->bd", *promote(window, p["conv_w"])) + p["conv_b"]
    xs_c = silu(conv_out)

    raw = dot(xs_c, p["x_proj"])
    dt = F.softplus(dot(raw[:, :R], p["dt_w"]).float() + p["dt_b"].float())
    B_t = raw[:, R:R + N].float()
    C_t = raw[:, R + N:].float()
    A = -torch.exp(p["A_log"].float())
    decay = torch.exp(dt[..., None] * A)
    h = decay * cache["h"] + (dt * xs_c.float())[..., None] * B_t[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, C_t).to(x.dtype)
    y, xd = promote(y, xs_c * p["D"])
    y = (y + xd) * silu(z)
    out = dot(y, p["out_proj"])[:, None, :]
    return out, {"conv": window[:, 1:, :].to(torch.bfloat16), "h": h}
