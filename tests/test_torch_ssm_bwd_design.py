"""The algebra of ``csrc/ssm_scan_bwd.cu``'s time-parallel design, on the CPU.

:func:`emulate` repeats, in torch on whole tensors, the order in which the
kernel computes the selective scan's backward:

- sweep 1 composes every trip of ``chunk`` steps apart, split into
  16-step time lanes (8 lanes where D is no multiple of 32).  Each lane's steps compose into
  one map h -> P h + hl (P the product of its decays, taken as
  2^(a2 sum dt)); a scan over the lanes joins them into the trip's map
  from a zero state, and the trips' maps are chained in order into the
  state at each trip's start (the kernel's ``hc`` scratch), the trip's P
  taken as 2^(a2 sum dt) over the whole trip;
- sweep 2 walks the trips in reverse.  Each group takes its decays once
  and keeps them, composes its forward map and its adjoint's map
  R -> P R + rl (R the adjoint handed to the step before, time reversed),
  joins the forward maps from the trip's start state over the groups
  before it and the adjoint maps from the next trip's carry over the
  groups after it, then walks its steps forward (e h_{t-1}, dC_t's terms)
  and backward (the adjoint g_t, dA, dx and ddt's sums over the states,
  dB_t's terms);
- dB_t and dC_t are summed over a thread's ``channels`` first, then over
  the lanes of a warp as the kernel's shuffles pair them (lane bit 0,
  then 1, ...), then over the warps in order and over the CTAs in order;
  dA a trip's groups in order onto a running sum, then the batch rows in
  order; dD a thread's steps, then the groups and the batch rows in order.

Held against ``ssm_scan_bwd_ref`` (the port's plain version) on float64
inputs at rtol 1e-10, with atol 1e-10 times the output's largest
magnitude (an element that sums to nearly 0 has no relative precision),
with the final state's gradient seeded and not; and on float32 inputs
against ``jax.vjp`` of ``repro.kernels.ssm_scan.ref.ssm_scan_ref`` at the
tolerances of ``test_ssm_bwd_plain_matches_jax_vjp``.  The shapes have S
off every multiple of ``seg`` and ``chunk`` (S = 1, 7, 129) and N = 12,
64, so a wrong join, a wrong carry between trips or a step past the end
that is not the identity shows here before the card runs the kernel.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan.ref import ssm_scan_ref as jax_ssm
from repro_torch.kernels.ssm_scan import ssm_scan as ssm_mod
from test_torch_scan_bwd import SSM_NAMES, _close, _jax_ssm_with_state, _ssm_inputs

WARP = 32
LOG2E = 1.0 / math.log(2.0)


def _lane_tree(v: torch.Tensor) -> torch.Tensor:
    """Sum the last axis (a warp's lanes, a power of two) as the kernel's
    shuffles pair them: lane bit 0 first, then bit 1, and so on."""
    while v.shape[-1] > 1:
        lanes = v.shape[-1]
        pairs = v.reshape(*v.shape[:-1], lanes // 2, 2)
        v = pairs[..., 0] + pairs[..., 1]
    return v[..., 0]


def _over_channels(v: torch.Tensor, block_d: int, channels: int, lanes: int) -> torch.Tensor:
    """(..., D) -> (...): a thread's channels in order, a warp's ``lanes``
    channel lanes by :func:`_lane_tree`, the CTA's warps in order, the CTAs
    in order."""
    D = v.shape[-1]
    v = v.reshape(*v.shape[:-1], D // block_d, block_d // (lanes * channels), lanes, channels)
    own = v[..., 0]
    for j in range(1, channels):
        own = own + v[..., j]
    warp = _lane_tree(own)
    cta = warp[..., 0]
    for w in range(1, warp.shape[-1]):
        cta = cta + warp[..., w]
    total = cta[..., 0]
    for p in range(1, cta.shape[-1]):
        total = total + cta[..., p]
    return total


def _scan_up(P: torch.Tensor, Q: torch.Tensor):
    """Kogge-Stone over the time lanes (axis 1) of the maps x -> P x + Q:
    each lane's composition of the lanes before it (exclusive; the identity
    at lane 0) and of all up to it (inclusive), as the kernel's shuffles
    pair them."""
    G = P.shape[1]
    o = 1
    while o < G:
        Pp = torch.cat([torch.ones_like(P[:, :o]), P[:, :-o]], 1)
        Qp = torch.cat([torch.zeros_like(Q[:, :o]), Q[:, :-o]], 1)
        Q, P = P * Qp + Q, P * Pp
        o *= 2
    Pe = torch.cat([torch.ones_like(P[:, :1]), P[:, :-1]], 1)
    Qe = torch.cat([torch.zeros_like(Q[:, :1]), Q[:, :-1]], 1)
    return (Pe, Qe), (P, Q)


def _scan_down(P: torch.Tensor, Q: torch.Tensor):
    """:func:`_scan_up` with time reversed: the lanes after each lane."""
    (Pe, Qe), (Pi, Qi) = _scan_up(P.flip(1), Q.flip(1))
    return (Pe.flip(1), Qe.flip(1)), (Pi.flip(1), Qi.flip(1))


def emulate(x, dt, A, Bc, Cc, skip, dy, dh=None, *, block_d: int, chunk: int, seg: int,
            channels: int = 1):
    """(dx, ddt, dA, dBc, dCc, dD) in the kernel's order (module note);
    arithmetic in float32, or float64 for float64 inputs."""
    wd = torch.promote_types(x.dtype, torch.float32)
    Bsz, S, D = x.shape
    N = A.shape[1]
    G, L = chunk // seg, seg  # G time lanes of a warp, one a segment
    lanes = WARP // G  # channel lanes
    trips = -(-S // chunk)
    pad = trips * chunk - S

    def steps(t):  # (B, S, X) -> (B, trips, G, L, X), steps past S zero
        t = torch.nn.functional.pad(t.to(wd), (0, 0, 0, pad))
        return t.reshape(Bsz, trips, G, L, t.shape[-1])

    xs, dts, dys, Bs, Cs = (steps(t) for t in (x, dt, dy, Bc, Cc))
    us = dts * xs
    a2 = A.to(wd) * LOG2E  # (D, N): e_t = 2^(dt_t a2)

    def decays(k):  # (B, G, L, D, N): each step's decay, taken once a sweep
        return torch.exp2(dts[:, k, :, :, :, None] * a2)

    def group_products(k):  # P of each group, (B, G, D, N)
        return torch.exp2(dts[:, k].sum(2)[..., None] * a2)

    # -- sweep 1: the state at the start of every trip but the first ------
    # (its own split of a trip: 16-step segments where D is a multiple of
    # 32, else 8 time lanes)
    Gm = chunk // 16 if D % 32 == 0 else 8
    Lm = chunk // Gm
    starts = [torch.zeros((Bsz, D, N), dtype=wd)]
    for k in range(trips - 1):
        dtm = dts[:, k].reshape(Bsz, Gm, Lm, D)
        um = us[:, k].reshape(Bsz, Gm, Lm, D)
        Bm = Bs[:, k].reshape(Bsz, Gm, Lm, N)
        hl = torch.zeros((Bsz, Gm, D, N), dtype=wd)
        for t in range(Lm):
            decay = torch.exp2(dtm[:, :, t, :, None] * a2)
            hl = decay * hl + um[:, :, t, :, None] * Bm[:, :, t, None, :]
        P = torch.exp2(dtm.sum(2)[..., None] * a2)
        _, (_, Q) = _scan_up(P, hl)  # the trip's map: the last lane's
        trip_dt = _lane_tree(dtm.sum(2).movedim(1, -1))  # (B, D), over the lanes
        starts.append(torch.exp2(trip_dt[..., None] * a2) * starts[-1] + Q[:, -1])

    # -- sweep 2: the trips in reverse -------------------------------------
    carry = torch.zeros((Bsz, D, N), dtype=wd) if dh is None else dh.to(wd)
    dx = torch.empty((Bsz, trips, G, L, D), dtype=wd)
    ddt = torch.empty_like(dx)
    dB = torch.empty((Bsz, trips, G, L, N), dtype=wd)
    dC = torch.empty_like(dB)
    dA_rows = torch.zeros((Bsz, D, N), dtype=wd)
    dsk = torch.zeros((Bsz, G, D), dtype=wd)  # a thread's dD terms, over its trips
    for k in reversed(range(trips)):
        for t in range(L):
            dsk = dsk + dys[:, k, :, t] * xs[:, k, :, t]
        e = decays(k)
        u, dtk, dyk = us[:, k], dts[:, k], dys[:, k]
        Bk, Ck = Bs[:, k], Cs[:, k]
        hl = torch.zeros((Bsz, G, D, N), dtype=wd)
        for t in range(L):
            hl = e[:, :, t] * hl + u[:, :, t, :, None] * Bk[:, :, t, None, :]
        rl = torch.zeros_like(hl)
        for t in reversed(range(L)):
            rl = e[:, :, t] * (dyk[:, :, t, :, None] * Ck[:, :, t, None, :] + rl)
        P = group_products(k)
        # the joins: forward from the trip's start over the lanes before,
        # the adjoint from the next trip's carry over the lanes after
        (Pe, Qe), _ = _scan_up(P, hl)
        h = Pe * starts[k][:, None] + Qe
        (Pe, Qe), (Pi, Qi) = _scan_down(P, rl)
        r = Pe * carry[:, None] + Qe
        carry = Pi[:, 0] * carry + Qi[:, 0]  # lane 0's: the trip's first step
        eh, hy = [], []
        for t in range(L):
            eh.append(e[:, :, t] * h)
            h = eh[-1] + u[:, :, t, :, None] * Bk[:, :, t, None, :]
            hy.append(h * dyk[:, :, t, :, None])
        sum_a = torch.zeros((Bsz, G, L, D), dtype=wd)
        sum_b = torch.zeros_like(sum_a)
        dA_seg = torch.zeros((Bsz, G, D, N), dtype=wd)
        gu = [None] * L
        for t in reversed(range(L)):
            g = dyk[:, :, t, :, None] * Ck[:, :, t, None, :] + r
            ghe = g * eh[t]
            sum_a[:, :, t] = (ghe * a2).sum(-1)
            dA_seg = dA_seg + ghe * dtk[:, :, t, :, None]
            sum_b[:, :, t] = (g * Bk[:, :, t, None, :]).sum(-1)
            gu[t] = g * u[:, :, t, :, None]
            r = e[:, :, t] * g
        # the time lanes by a butterfly, onto the running sum
        dA_rows = dA_rows + _lane_tree(dA_seg.movedim(1, -1))
        dx[:, k] = dtk * sum_b + skip.to(wd) * dyk
        ddt[:, k] = xs[:, k] * sum_b + sum_a * math.log(2.0)
        for t in range(L):  # (B, G, D, N) -> (B, G, N): over the channels
            dB[:, k, :, t] = _over_channels(gu[t].transpose(-1, -2), block_d, channels, lanes)
            dC[:, k, :, t] = _over_channels(hy[t].transpose(-1, -2), block_d, channels, lanes)
    dsk_rows = dsk[:, 0]
    for w in range(1, G):
        dsk_rows = dsk_rows + dsk[:, w]
    dA, dD = dA_rows[0], dsk_rows[0]  # the batch rows in order
    for b in range(1, Bsz):
        dA, dD = dA + dA_rows[b], dD + dsk_rows[b]
    flat = lambda t: t.reshape(Bsz, trips * chunk, t.shape[-1])[:, :S]  # noqa: E731
    return (flat(dx).to(x.dtype), flat(ddt).to(dt.dtype), dA.to(A.dtype),
            flat(dB).to(Bc.dtype), flat(dC).to(Cc.dtype), dD.to(skip.dtype))


# (B, S, D, N, block_d, chunk, seg, channels), each a tile the kernel
# takes: S = 1, 7, 129 against trips of 32 or 64 steps, 4 or 8 time lanes
# (8 or 4 channel lanes), segments of 4 to 16 steps, one or two channels a
# thread, one warp a CTA or several
DESIGN_CASES = [(2, 1, 8, 12, 8, 32, 4, 1), (2, 7, 8, 12, 8, 32, 8, 1),
                (1, 7, 16, 64, 16, 32, 4, 2), (2, 129, 8, 12, 8, 32, 4, 1),
                (1, 129, 8, 64, 8, 64, 8, 1), (3, 129, 64, 12, 64, 64, 16, 1),
                (1, 129, 64, 64, 32, 32, 8, 2), (2, 129, 16, 12, 16, 64, 8, 1),
                (1, 129, 32, 12, 32, 32, 8, 1)]


def _case_inputs(B, S, D, N):
    return _ssm_inputs(1000 * S + 10 * N + B, B, S, D, N)


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("B,S,D,N,block_d,chunk,seg,channels", DESIGN_CASES)
def test_design_matches_the_plain_backward_float64(B, S, D, N, block_d, chunk, seg, channels,
                                                   seeded):
    assert ssm_mod.bwd_refusal(D, block_d, chunk, seg, channels) is None
    arrays = _case_inputs(B, S, D, N)
    args = [torch.from_numpy(a.astype(np.float64)) for a in arrays]
    dh = args[7] if seeded else None
    want = ssm_mod.ssm_scan_bwd_plain(*args[:7], dh)
    got = emulate(*args[:7], dh, block_d=block_d, chunk=chunk, seg=seg, channels=channels)
    for name, g, w in zip(SSM_NAMES, got, want):
        assert g.dtype == torch.float64 and g.shape == w.shape, name
        scale = float(w.abs().max())
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10 * scale, msg=name)


@pytest.mark.parametrize("B,S,D,N,block_d,chunk,seg,channels", DESIGN_CASES)
def test_design_matches_jax_vjp_float32(B, S, D, N, block_d, chunk, seg, channels):
    x, dt, A, Bc, Cc, Dp, dy, _ = _case_inputs(B, S, D, N)
    _, vjp = jax.vjp(jax_ssm, *map(jnp.asarray, (x, dt, A, Bc, Cc, Dp)))
    want = vjp(jnp.asarray(dy))
    got = emulate(*(torch.from_numpy(a) for a in (x, dt, A, Bc, Cc, Dp, dy)),
                  block_d=block_d, chunk=chunk, seg=seg, channels=channels)
    for name, g, w in zip(SSM_NAMES, got, want):
        assert g.dtype == torch.float32, name
        _close(g, w, "float32", f"{name} S={S} N={N}", summed=name in ("dA", "dD"))


@pytest.mark.parametrize("S", [7, 129])
def test_design_seeds_the_adjoint_like_jax(S):
    """The final state's gradient enters the last trip's carry: against
    ``jax.vjp`` of the scan that also returns its final state."""
    B, D, N = 2, 8, 12
    x, dt, A, Bc, Cc, Dp, dy, dh = _case_inputs(B, S, D, N)
    _, vjp = jax.vjp(_jax_ssm_with_state, *map(jnp.asarray, (x, dt, A, Bc, Cc, Dp)))
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    got = emulate(*(torch.from_numpy(a) for a in (x, dt, A, Bc, Cc, Dp, dy, dh)),
                  block_d=8, chunk=32, seg=4, channels=1)
    for name, g, w in zip(SSM_NAMES, got, want):
        _close(g, w, "float32", f"{name} with dh S={S}", summed=name in ("dA", "dD"))
