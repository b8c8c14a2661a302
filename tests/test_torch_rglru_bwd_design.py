"""The algebra of ``csrc/rglru_scan_bwd.cu``'s trip-parallel design, on the CPU.

:func:`emulate` repeats, in torch on whole tensors, the order in which the
kernel computes the RG-LRU scan's backward:

- a trip is ``chunk`` steps; thread p of a channel takes the segment of L
  steps [p L, p L + L) of it (``seg_len(chunk, split)``), the trip's rows
  past its end and the sequence's end read as 0 (the identity step);
- the maps pass: each segment composes its forward map h -> A h + H from
  h = 0 (A the product of its a_t, in order) and its adjoint map
  G -> A G + Hr from its last step to its first; a Kogge-Stone up-scan and
  down-scan over the lanes join them, and the trip keeps A and H of its
  last lane and Hr of its first;
- the chain pass walks the trips in order: the state at each trip's start
  (h_{k+1} = A_k h_k + H_k) and, back from the last trip, the carry
  entering each trip's last step (G_k = A_{k+1} G_{k+1} + Hr_{k+1});
- the gradient pass reruns each trip from its start state and joins the
  adjoint from its carry with the same scans, walks each segment backward
  for dx, dr and di (1 - a^2 as (1 - a)(1 + a) from ``expm1``, the square
  root's derivative 0 where the clamp holds), and sums dlam's terms over a
  segment's steps, then over the channel's lanes as the kernel's xor
  shuffles pair them;
- the reduce adds the partials over the batch rows and trips in order.

Held against ``rglru_scan_bwd_ref`` (the port's plain version) on float64
inputs at rtol 1e-10, with atol 1e-10 times the output's largest
magnitude; and on float32 inputs against ``jax.vjp`` of
``repro.kernels.rglru_scan.ref.rglru_scan_ref`` at the tolerances of
``test_rglru_bwd_plain_matches_jax_vjp``.  S runs at 1, 7, 129 and 300
against trips of 1 to 256 steps, so S falls off every multiple of the
segment and the trip, a trip may hold fewer rows than its segments
(``chunk`` no multiple of L), and the chain walks more trips than it loads
at once.  Two cases set the inputs' extremes: a_t near 1 (lambda from
u = 0.999), and a clamp that holds (1 - a^2 far below 1e-12 in every
precision, so float32 JAX, the plain version and the kernel all drop the
square root's derivative).
"""
from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru_scan.ref import rglru_scan_ref as jax_rglru
from repro_torch.core import pp_key
from repro_torch.core.arch import CPU_HOST
from repro_torch.core.emit import TileDim, TilePolicy
from repro_torch.kernels.rglru_scan import ops as rg_ops
from repro_torch.kernels.rglru_scan import rglru_scan as rg_mod
from test_torch_arch import SXM
from test_torch_scan_bwd import _close, _rglru_inputs

C_FACTOR = 8.0
NAMES = ("dx", "dr", "di", "dlam")


def _scan_up(P: torch.Tensor, Q: torch.Tensor):
    """Kogge-Stone over the lanes (axis -2) of the maps v -> P v + Q: each
    lane's composition of the lanes before it (exclusive; the identity at
    lane 0) and of all up to it (inclusive), as the kernel's shuffles pair
    them."""
    G = P.shape[-2]
    o = 1
    while o < G:
        Pp = torch.cat([torch.ones_like(P[..., :o, :]), P[..., :-o, :]], -2)
        Qp = torch.cat([torch.zeros_like(Q[..., :o, :]), Q[..., :-o, :]], -2)
        Q, P = P * Qp + Q, P * Pp
        o *= 2
    Pe = torch.cat([torch.ones_like(P[..., :1, :]), P[..., :-1, :]], -2)
    Qe = torch.cat([torch.zeros_like(Q[..., :1, :]), Q[..., :-1, :]], -2)
    return (Pe, Qe), (P, Q)


def _scan_down(P: torch.Tensor, Q: torch.Tensor):
    """:func:`_scan_up` with time reversed: the lanes after each lane."""
    (Pe, Qe), (Pi, Qi) = _scan_up(P.flip(-2), Q.flip(-2))
    return (Pe.flip(-2), Qe.flip(-2)), (Pi.flip(-2), Qi.flip(-2))


def _lane_tree(v: torch.Tensor) -> torch.Tensor:
    """Sum axis -2 (a channel's lanes, a power of two) as the kernel's xor
    shuffles leave it on lane 0: lanes p and p + half first, then halves
    again."""
    while v.shape[-2] > 1:
        half = v.shape[-2] // 2
        v = v[..., :half, :] + v[..., half:, :]
    return v[..., 0, :]


def _trips(t: torch.Tensor, S: int, ck: int, split: int, L: int) -> torch.Tensor:
    """(B, S, W) -> (B, trips, split, L, W): trip k's row j at position j of
    its split * L, the positions past the trip's rows or S zero."""
    B, _, W = t.shape
    trips = -(-S // ck)
    t = torch.nn.functional.pad(t, (0, 0, 0, trips * ck - S)).reshape(B, trips, ck, W)
    t = torch.nn.functional.pad(t, (0, 0, 0, split * L - ck))
    return t.reshape(B, trips, split, L, W)


def emulate(x, r, i, lam, dy, *, block_w: int, chunk: int, split: int):
    """(dx, dr, di, dlam) in the kernel's order (module note); arithmetic in
    float32, or float64 for float64 inputs."""
    wd = torch.promote_types(x.dtype, torch.float32)
    B, S, W = x.shape
    assert W % block_w == 0  # a CTA's channels change nothing of the order
    ck = min(chunk, S)
    L = rg_mod.seg_len(ck, split)
    assert L and rg_mod.takes_split(ck, split)
    trips = -(-S // ck)
    xs, rs, is_, dys = (_trips(t.to(wd), S, ck, split, L) for t in (x, r, i, dy))
    sp = torch.logaddexp(-lam.to(wd), torch.zeros((), dtype=wd))
    kr = -C_FACTOR * sp
    a = torch.exp(rs * kr)
    gain = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    bx = gain * (is_ * xs)

    def compose(k):  # each segment's forward map and adjoint map, (B, split, W)
        A = torch.ones((B, split, W), dtype=wd)
        H = torch.zeros_like(A)
        for j in range(L):
            H = a[:, k, :, j] * H + bx[:, k, :, j]
            A = A * a[:, k, :, j]
        Hr = torch.zeros_like(A)
        for j in reversed(range(L)):
            Hr = a[:, k, :, j] * (Hr + dys[:, k, :, j])
        return A, H, Hr

    # -- the maps pass and the chain ----------------------------------------
    maps = []
    for k in range(trips):
        A, H, Hr = compose(k)
        _, (Af, Hf) = _scan_up(A, H)
        _, (_, Hb) = _scan_down(A, Hr)
        maps.append((Af[:, -1], Hf[:, -1], Hb[:, 0]))
    starts, carries = [None] * trips, [None] * trips
    h = torch.zeros((B, W), dtype=wd)
    for k in range(trips):
        starts[k] = h
        h = maps[k][0] * h + maps[k][1]
    g = torch.zeros((B, W), dtype=wd)
    for k in reversed(range(trips)):
        carries[k] = g
        g = maps[k][0] * g + maps[k][2]

    # -- the gradient pass ---------------------------------------------------
    dx, dr, di = (torch.empty((B, trips, split, L, W), dtype=wd) for _ in range(3))
    part = torch.empty((B, trips, W), dtype=wd)
    for k in range(trips):
        A, H, Hr = compose(k)
        (Ae, He), _ = _scan_up(A, H)
        (Ad, Hd), _ = _scan_down(A, Hr)
        h = Ae * starts[k][:, None] + He
        hp = []
        for j in range(L):
            hp.append(h)
            h = a[:, k, :, j] * h + bx[:, k, :, j]
        Gc = Ad * carries[k][:, None] + Hd
        lam_sum = torch.zeros((B, split, W), dtype=wd)
        for j in reversed(range(L)):
            at, xv, rv, iv = a[:, k, :, j], xs[:, k, :, j], rs[:, k, :, j], is_[:, k, :, j]
            gt = dys[:, k, :, j] + Gc
            om = -torch.expm1(rv * kr)
            m = om * (2.0 - om)
            clamped = torch.clamp(m, min=1e-12)
            gs = gt * torch.sqrt(clamped)
            da = gt * hp[j]
            da = torch.where(m > 1e-12, da - gt * (iv * xv) * (at / torch.sqrt(clamped)), da)
            lam_sum = lam_sum + da * at * rv
            dx[:, k, :, j], dr[:, k, :, j], di[:, k, :, j] = gs * iv, da * at * kr, gs * xv
            Gc = at * gt
        part[:, k] = _lane_tree(lam_sum)

    # -- the reduce ------------------------------------------------------------
    total = torch.zeros((W,), dtype=wd)
    for b in range(B):
        for k in range(trips):
            total = total + part[b, k]
    dlam = C_FACTOR * total / (1.0 + torch.exp(lam.to(wd)))

    def flat(t):
        t = t.reshape(B, trips, split * L, W)[:, :, :ck]
        return t.reshape(B, trips * ck, W)[:, :S]

    return (flat(dx).to(x.dtype), flat(dr).to(r.dtype), flat(di).to(i.dtype), dlam.to(lam.dtype))


# (B, S, W, block_w, chunk, split), each a tile the kernel takes: S = 1, 7,
# 129, 300 against trips of 1 to 256 steps; segments of 4 to 16 steps, one
# to 32 lanes a channel; a trip short of its segments (chunk 7 and 24 at
# L = 4 and 16); 33 trips, more than the chain loads at once
DESIGN_CASES = [(2, 1, 8, 8, 1, 1), (2, 7, 24, 8, 7, 2), (2, 7, 8, 8, 8, 1),
                (1, 129, 16, 16, 32, 4), (3, 129, 8, 4, 24, 2), (1, 129, 8, 8, 4, 1),
                (1, 300, 16, 8, 128, 16), (2, 300, 8, 8, 64, 8), (1, 300, 8, 8, 256, 32)]


def _case_inputs(B, S, W):
    return _rglru_inputs(1000 * S + 10 * W + B, B, S, W)


def _near_one(B, S, W):
    """a_t near 1: lambda = logit(0.999) on every channel (the top of
    ``make_inputs``' range).  At 0.9999 float32 JAX's own gradient is off by
    8.6e-5 of dr's largest element against float64 (its 1 - a^2 cancels),
    the emulation in float32 by 4.4e-7."""
    x, r, i, lam, dy = _case_inputs(B, S, W)
    lam[:] = np.float32(np.log(0.999 / 0.001))
    return x, r, i, lam, dy


def _clamped(B, S, W):
    """The clamp holds at a few steps: lambda = -20 (softplus(-lambda) ~ 20)
    and r = 1e-15 there, so 1 - a^2 ~ 3e-13 even as (1 - a)(1 + a)."""
    x, r, i, lam, dy = _case_inputs(B, S, W)
    lam[:] = -20.0
    r[:, ::5] = 1e-15
    return x, r, i, lam, dy


EXTREMES = {"near_one": _near_one, "clamped": _clamped}


def _check_float64(arrays, tiles):
    args = [torch.from_numpy(a.astype(np.float64)) for a in arrays]
    want = rg_mod.rglru_scan_bwd_plain(*args)
    got = emulate(*args, **tiles)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float64 and g.shape == w.shape, name
        scale = float(w.abs().max())
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10 * scale, msg=name)


def _check_jax_float32(arrays, tiles, label):
    x, r, i, lam, dy = arrays
    _, vjp = jax.vjp(jax_rglru, *map(jnp.asarray, (x, r, i, lam)))
    want = vjp(jnp.asarray(dy))
    got = emulate(*(torch.from_numpy(a) for a in arrays), **tiles)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32, name
        _close(g, w, "float32", f"{name} {label}", summed=name == "dlam")


def _tiles(block_w, chunk, split):
    return dict(block_w=block_w, chunk=chunk, split=split)


@pytest.mark.parametrize("B,S,W,block_w,chunk,split", DESIGN_CASES)
def test_design_matches_the_plain_backward_float64(B, S, W, block_w, chunk, split):
    assert rg_mod.takes_split(min(chunk, S), split) and W % block_w == 0
    _check_float64(_case_inputs(B, S, W), _tiles(block_w, chunk, split))


@pytest.mark.parametrize("B,S,W,block_w,chunk,split", DESIGN_CASES)
def test_design_matches_jax_vjp_float32(B, S, W, block_w, chunk, split):
    _check_jax_float32(_case_inputs(B, S, W), _tiles(block_w, chunk, split), f"S={S}")


@pytest.mark.parametrize("extreme", sorted(EXTREMES))
@pytest.mark.parametrize("S,chunk,split", [(129, 32, 4), (300, 64, 8)])
def test_design_at_the_extremes(extreme, S, chunk, split):
    arrays = EXTREMES[extreme](2, S, 16)
    tiles = _tiles(8, chunk, split)
    _check_float64(arrays, tiles)
    _check_jax_float32(arrays, tiles, f"{extreme} S={S}")


# -- the hint: a CTA an item ------------------------------------------------------


def test_a_programs_model_replaces_the_dims_count():
    """``programs_model`` sets the hint's CTAs (and so its waves and SM
    fill) in place of the dims' count and the batch multiplier."""
    def policy(**kw):
        return TilePolicy(kernel="toy", dims=lambda bp: (TileDim("a", 64, semantic="grid"),),
                          vmem_model=lambda bp, p: 0, traffic_model=lambda bp, p: (0.0, 1e9),
                          grid_multiplier=lambda bp: 4, **kw)

    plain = policy().emit(CPU_HOST, {})
    held = policy(programs_model=lambda arch, bp, p: 3 * arch.sm_count).emit(CPU_HOST, {})
    for key, hint in plain.hints.items():
        assert hint["programs"] == 4 * (64 // json.loads(key)["a"])
        assert held.hints[key]["programs"] == 3 * CPU_HOST.sm_count
        assert held.hints[key]["waves"] == 3 and held.hints[key]["sm_fill"] == 1.0


def test_the_backward_hint_counts_the_ctas_an_sm_holds():
    """At (1, 2048, 2560) f32 and (block_w, chunk, split) = (32, 64, 4) each
    trip pass has 2560 items (80 channel blocks, 32 trips); an SM holds 4
    of their 128-thread CTAs (the gradient pass's 127 registers a thread;
    6 by shared memory), so the hint's CTAs are 4 x 132, its waves 4, and
    the 2560 items take them 5 rounds (the latency's rounds)."""
    bp = {"width": 2560, "seq": 2048, "batch": 1, "dtype": "float32"}
    point = dict(block_w=32, chunk=64, split=4)
    assert rg_ops._bwd_items(bp, point) == 2560
    assert rg_ops._bwd_resident(SXM, bp, point) == 4
    hint = rg_ops.rglru_bwd_region(2560, 2048, 1, arch=SXM).hints[pp_key(point)]
    assert hint["programs"] == 4 * SXM.sm_count and hint["waves"] == 4
