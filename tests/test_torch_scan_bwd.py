"""The scans' backward: the plain versions against ``jax.vjp`` of the JAX
scan references, the port's autograd Functions, and the two backward
registry ops.

``ssm_scan_bwd_plain`` and ``rglru_scan_bwd_plain`` (explicit reverse-time
scans, not autograd) against ``jax.vjp`` of
``repro.kernels.ssm_scan.ref.ssm_scan_ref`` and
``repro.kernels.rglru_scan.ref.rglru_scan_ref`` on the same numpy inputs,
drawn as the JAX ``make_inputs`` draws them; the final state's cotangent
of the selective scan against ``jax.vjp`` of the same ``lax.scan`` step
returning its carry as well.  Tolerances: float32 per element within the
scans' ``DEFAULT_TOL`` (1e-4, 1e-4), the gradients summed over batch and
time (dA, dD, dλ) within a relative norm of 1e-4 (their elements add up to
B·S terms); bf16 worst row ‖port − jax‖ / ‖jax‖ within 4·2⁻⁸ (four bf16
ulps: both round the gradient to bf16 once, JAX through its own
transposed scan).  Measured worst: float32 per element 0.23 of the
allowed |port − jax| / (atol + rtol·|jax|), the summed gradients 1.05e-6
relative; bf16 rows 6.9e-3 (ssm, dx at S = 129, N = 12) and 6.1e-7
(rglru, dr at S = 129).

``SelectiveScanFn`` and ``LruScanFn`` on their plain versions pass
``torch.autograd.gradcheck`` in float64, run under remat ``full`` and
``dots`` (their forward runs again in the recompute), and one CPU train
step of the falcon-mamba and recurrentgemma SMOKE configs with the model
routed through them (``on_kernel`` monkeypatched, so the registry ops run
on CPU tensors) equals the JAX step within ``tests/test_torch_train_step.py``'s
tolerances.  The CUDA kernels are held against the same plain versions on
the card by ``chip_smoke.py``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from conformance import DEFAULT_TOL
from repro.kernels.rglru_scan.ref import rglru_scan_ref as jax_rglru
from repro.kernels.ssm_scan.ref import ssm_scan_ref as jax_ssm
from repro_torch.configs import get_config
from repro_torch.core import autotuned, get_kernel
from repro_torch.core.arch import CPU_HOST
from repro_torch.kernels.rglru_scan import ops as rg_ops
from repro_torch.kernels.rglru_scan import rglru_scan as rg_mod
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.kernels.ssm_scan import ssm_scan as ssm_mod
from repro_torch.models import rglru, ssm
from repro_torch.models.transformer import maybe_checkpoint
from test_torch_arch import SXM
from test_torch_serve_common import restore_port_registry  # noqa: F401  (autouse)
from test_torch_train_step import check_train_step_matches_jax

TOL = DEFAULT_TOL["float32"]  # (1e-4, 1e-4), the scans' conformance tolerance
SUM_TOL = 1e-4
BF16_ROW = 4 * 2.0 ** -8
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (B, S, D, N, dtype): every S, N, B and dtype of the plain backward's cases
SSM_CASES = [(1, 1, 8, 4, "float32"), (3, 7, 8, 12, "float32"), (1, 64, 16, 16, "float32"),
             (3, 129, 8, 64, "float32"), (3, 64, 8, 4, "float32"), (1, 129, 16, 16, "float32"),
             (1, 7, 8, 16, "bfloat16"), (3, 129, 8, 12, "bfloat16"), (1, 64, 8, 64, "bfloat16"),
             (3, 1, 8, 4, "bfloat16")]
RGLRU_CASES = [(1, 1, 8, "float32"), (3, 7, 24, "float32"), (1, 64, 16, "float32"),
               (3, 129, 8, "float32"), (1, 7, 8, "bfloat16"), (3, 129, 24, "bfloat16"),
               (1, 64, 16, "bfloat16"), (3, 1, 8, "bfloat16")]


def _ssm_inputs(seed, B, S, D, N):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((B, S, D)).astype(f),
            np.logaddexp(rng.standard_normal((B, S, D)) - 1.0, 0.0).astype(f),
            -np.exp(rng.standard_normal((D, N)) * 0.5).astype(f),
            rng.standard_normal((B, S, N)).astype(f),
            rng.standard_normal((B, S, N)).astype(f),
            rng.standard_normal((D,)).astype(f),
            rng.standard_normal((B, S, D)).astype(f),   # dy
            rng.standard_normal((B, D, N)).astype(f))   # dh


def _rglru_inputs(seed, B, S, W):
    rng = np.random.default_rng(seed)
    f = np.float32
    u = rng.uniform(0.9, 0.999, (W,))
    return (rng.standard_normal((B, S, W)).astype(f),
            (1 / (1 + np.exp(-rng.standard_normal((B, S, W))))).astype(f),
            (1 / (1 + np.exp(-rng.standard_normal((B, S, W))))).astype(f),
            np.log(u / (1 - u)).astype(f),
            rng.standard_normal((B, S, W)).astype(f))   # dy


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _close(got, want, dtype, label, summed=False):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, label
    if summed:
        rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert rel <= SUM_TOL, f"{label}: {rel}"
    elif dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=TOL[0], atol=TOL[1], err_msg=label)
    else:
        rows = np.linalg.norm((got - want).reshape(-1, got.shape[-1]), axis=-1) / np.maximum(
            np.linalg.norm(want.reshape(-1, want.shape[-1]), axis=-1), 1e-30)
        assert rows.max() <= BF16_ROW, f"{label}: worst row {rows.max()}"


def _jax_ssm_with_state(x, dt, A, Bc, Cc, D):
    """``ssm_scan_ref``'s scan, returning its carry too: the final state."""
    def step(h, inputs):
        x_t, dt_t, B_t, C_t = inputs
        h = jnp.exp(dt_t[..., None] * A) * h + (dt_t * x_t)[..., None] * B_t[:, None, :]
        return h, jnp.einsum("bdn,bn->bd", h, C_t)

    h0 = jnp.zeros((x.shape[0], x.shape[2], A.shape[1]), jnp.float32)
    seq = tuple(a.transpose(1, 0, 2).astype(jnp.float32) for a in (x, dt, Bc, Cc))
    h, ys = lax.scan(step, h0, seq)
    y = ys.transpose(1, 0, 2) + x.astype(jnp.float32) * D
    return y.astype(x.dtype), h


SSM_NAMES = ("dx", "ddt", "dA", "dBc", "dCc", "dD")


@pytest.mark.parametrize("B,S,D,N,dtype", SSM_CASES)
def test_ssm_bwd_plain_matches_jax_vjp(B, S, D, N, dtype):
    jdt, tdt = DTYPES[dtype]
    x, dt, A, Bc, Cc, Dp, dy, _ = _ssm_inputs(S * N + B, B, S, D, N)
    cast = (jdt, jdt, jnp.float32, jdt, jdt, jnp.float32)
    args = [jnp.asarray(a, c) for a, c in zip((x, dt, A, Bc, Cc, Dp), cast)]
    _, vjp = jax.vjp(jax_ssm, *args)
    want = vjp(jnp.asarray(dy, jdt))
    targs = [_t(np.asarray(a, np.float32), t) for a, t in
             zip(args, (tdt, tdt, torch.float32, tdt, tdt, torch.float32))]
    got = ssm_mod.ssm_scan_bwd_plain(*targs, _t(np.asarray(jnp.asarray(dy, jdt), np.float32),
                                                 tdt))
    for name, g, w, t in zip(SSM_NAMES, got, want, targs):
        assert g.dtype == t.dtype, name
        _close(g, w, dtype, f"{name} B={B} S={S} N={N} {dtype}", summed=name in ("dA", "dD"))


@pytest.mark.parametrize("B,S,D,N", [(3, 7, 8, 12), (1, 64, 16, 16), (3, 129, 8, 4)])
def test_ssm_bwd_plain_seeds_the_adjoint_with_the_final_state(B, S, D, N):
    x, dt, A, Bc, Cc, Dp, dy, dh = _ssm_inputs(S + 7 * N, B, S, D, N)
    _, vjp = jax.vjp(_jax_ssm_with_state, *map(jnp.asarray, (x, dt, A, Bc, Cc, Dp)))
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    got = ssm_mod.ssm_scan_bwd_plain(*map(_t, (x, dt, A, Bc, Cc, Dp, dy)), _t(dh))
    for name, g, w in zip(SSM_NAMES, got, want):
        _close(g, w, "float32", f"{name} with dh S={S}", summed=name in ("dA", "dD"))
    no_dh = ssm_mod.ssm_scan_bwd_plain(*map(_t, (x, dt, A, Bc, Cc, Dp, dy)))
    assert not torch.allclose(no_dh[0], got[0])  # the seed reaches dx


@pytest.mark.parametrize("B,S,W,dtype", RGLRU_CASES)
def test_rglru_bwd_plain_matches_jax_vjp(B, S, W, dtype):
    jdt, tdt = DTYPES[dtype]
    x, r, i, lam, dy = _rglru_inputs(S * W + B, B, S, W)
    args = [jnp.asarray(a, c) for a, c in zip((x, r, i, lam), (jdt, jdt, jdt, jnp.float32))]
    _, vjp = jax.vjp(jax_rglru, *args)
    want = vjp(jnp.asarray(dy, jdt))
    targs = [_t(np.asarray(a, np.float32), t) for a, t in
             zip(args, (tdt, tdt, tdt, torch.float32))]
    got = rg_mod.rglru_scan_bwd_plain(*targs, _t(np.asarray(jnp.asarray(dy, jdt), np.float32),
                                                 tdt))
    for name, g, w, t in zip(("dx", "dr", "di", "dlam"), got, want, targs):
        assert g.dtype == t.dtype, name
        _close(g, w, dtype, f"{name} B={B} S={S} {dtype}", summed=name == "dlam")


def test_rglru_bwd_plain_drops_the_clamped_square_root():
    """Where 1 - a² is at or below 1e-12 (r large, λ small) the square
    root's derivative is 0, as JAX's ``maximum`` gives it away from a tie."""
    x, r, i, lam, dy = _rglru_inputs(5, 1, 6, 4)
    lam[:] = -20.0  # softplus(-λ) ≈ 20: a = exp(-8 r · 20) ≈ 0, no clamp ...
    r[0, :3] = 1e-14  # ... but a ≈ 1 here: 1 - a² ≈ 3e-12 or less
    _, vjp = jax.vjp(jax_rglru, *map(jnp.asarray, (x, r, i, lam)))
    want = vjp(jnp.asarray(dy))
    got = rg_mod.rglru_scan_bwd_plain(*map(_t, (x, r, i, lam, dy)))
    for name, g, w in zip(("dx", "dr", "di", "dlam"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4 * max(
            1.0, float(np.abs(np.asarray(w)).max())), err_msg=name)


# -- the autograd Functions ------------------------------------------------------


def _f64(rng, *shape, fn=lambda a: a):
    return torch.from_numpy(fn(rng.standard_normal(shape))).requires_grad_()


def _ssm_leaves(seed, B=2, S=5, D=3, N=4):
    rng = np.random.default_rng(seed)
    return (_f64(rng, B, S, D), _f64(rng, B, S, D, fn=lambda a: np.logaddexp(a - 1, 0)),
            _f64(rng, D, N, fn=lambda a: -np.exp(a / 2)), _f64(rng, B, S, N),
            _f64(rng, B, S, N), _f64(rng, D))


def _rglru_leaves(seed, B=2, S=6, W=3):
    rng = np.random.default_rng(seed)
    sig = lambda a: 1 / (1 + np.exp(-a))  # noqa: E731
    return (_f64(rng, B, S, W), _f64(rng, B, S, W, fn=sig), _f64(rng, B, S, W, fn=sig),
            _f64(rng, W, fn=lambda a: 2.5 + a / 4))


def _ssm_plain_forward(x, dt, A, Bc, Cc, skip, final_state):
    return ssm_mod.ssm_scan_plain(x, dt, A, Bc, Cc, skip, final_state=final_state)


@pytest.mark.parametrize("final_state", [False, True])
def test_selective_scan_fn_gradcheck_float64(final_state):
    leaves = _ssm_leaves(1)
    assert torch.autograd.gradcheck(
        lambda *a: ssm.SelectiveScanFn.apply(*a, final_state, _ssm_plain_forward,
                                             ssm_mod.ssm_scan_bwd_plain), leaves)


def test_lru_scan_fn_gradcheck_float64():
    assert torch.autograd.gradcheck(
        lambda *a: rglru.LruScanFn.apply(*a, rg_mod.rglru_scan_plain,
                                         rg_mod.rglru_scan_bwd_plain), _rglru_leaves(2))


def test_selective_scan_fn_final_state_alone_seeds_the_adjoint():
    """A loss of the final state alone (no gradient reaches y) still
    differentiates: the Function gives dy as zeros and dh as the seed."""
    leaves = _ssm_leaves(3)
    _, h = ssm.SelectiveScanFn.apply(*leaves, True, _ssm_plain_forward,
                                     ssm_mod.ssm_scan_bwd_plain)
    got = torch.autograd.grad(h.square().sum(), leaves[:5])
    ref = [t.detach().clone().requires_grad_() for t in leaves]
    _, h_ref = ssm_mod.ssm_scan_plain(*ref, final_state=True)
    want = torch.autograd.grad(h_ref.square().sum(), ref[:4])  # h does not read C
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-12)
    assert not got[4].any()


def _remat_case(fn, leaves, remat):
    """Gradients of ``fn`` over ``leaves`` without remat and under
    ``remat``, and the calls of its forward and backward in each."""
    def grads(f):
        work = [t.detach().clone().requires_grad_() for t in leaves]
        return torch.autograd.grad(f(*work).square().sum(), work)

    calls = []
    want = grads(lambda *a: fn(calls, *a))
    first, calls[:] = list(calls), []
    cfg = get_config("falcon-mamba-7b", smoke=True).with_(remat=remat)
    got = grads(maybe_checkpoint(lambda *a: fn(calls, *a), cfg))
    return want, got, first, list(calls)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_selective_scan_fn_under_remat(remat):
    """Under ``full`` and ``dots`` the Function's forward runs again in the
    recompute and its saved inputs reach its backward: the gradients equal
    those without remat."""
    rng = np.random.default_rng(7)
    w = torch.from_numpy(rng.standard_normal((3, 3)) / 2)
    leaves = _ssm_leaves(4) + (w.requires_grad_(),)

    def fn(calls, x, dt, A, Bc, Cc, skip, w):
        def fwd(*a):
            calls.append("forward")
            return _ssm_plain_forward(*a)

        def bwd(*a):
            calls.append("backward")
            return ssm_mod.ssm_scan_bwd_plain(*a)

        y = ssm.SelectiveScanFn.apply(x @ w, dt, A, Bc, Cc, skip, False, fwd, bwd)
        return y @ w

    want, got, first, calls = _remat_case(fn, leaves, remat)
    assert first == ["forward", "backward"]
    assert calls == ["forward", "forward", "backward"]
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_lru_scan_fn_under_remat(remat):
    rng = np.random.default_rng(8)
    w = torch.from_numpy(rng.standard_normal((3, 3)) / 2)
    leaves = _rglru_leaves(5) + (w.requires_grad_(),)

    def fn(calls, x, r, i, lam, w):
        def fwd(*a):
            calls.append("forward")
            return rg_mod.rglru_scan_plain(*a)

        def bwd(*a):
            calls.append("backward")
            return rg_mod.rglru_scan_bwd_plain(*a)

        return rglru.LruScanFn.apply(x @ w, r, i, lam, fwd, bwd) @ w

    want, got, first, calls = _remat_case(fn, leaves, remat)
    assert first == ["forward", "backward"]
    assert calls == ["forward", "forward", "backward"]
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=1e-10, atol=1e-12)


def test_scans_on_the_cpu_differentiate_through_the_plain_versions():
    """On CPU tensors the models' scans are the plain versions, and
    autograd differentiates them as torch ops (no Function, no registry)."""
    x, dt, A, Bc, Cc, _ = (t.detach().float().requires_grad_() for t in _ssm_leaves(9))
    before = (ssm_mod.counter.plain_calls, ssm_mod.bwd_counter.plain_calls)
    ssm.selective_scan(x, dt, A, Bc, Cc).square().sum().backward()
    assert (ssm_mod.counter.plain_calls, ssm_mod.bwd_counter.plain_calls) == (
        before[0] + 1, before[1])
    xr, r, i, lam = (t.detach().float().requires_grad_() for t in _rglru_leaves(10))
    rglru.lru_scan(xr, r, i, lam).square().sum().backward()
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all())
               for t in (x, dt, A, Bc, Cc, xr, r, i, lam))


# -- the registry ops ------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_bwd_registry_op_on_cpu_tensors(dtype):
    tdt = DTYPES[dtype][1]
    x, dt, A, Bc, Cc, Dp, dy, dh = _ssm_inputs(11, 2, 40, 16, 16)
    args = (_t(x, tdt), _t(dt, tdt), _t(A), _t(Bc, tdt), _t(Cc, tdt), _t(Dp), _t(dy, tdt),
            _t(dh))
    before = ssm_mod.bwd_counter.plain_calls
    got = autotuned("ssm_scan_bwd")(*args)
    assert ssm_mod.bwd_counter.plain_calls > before
    for g, w in zip(got, ssm_mod.ssm_scan_bwd_plain(*args)):
        assert torch.equal(g, w)
    bp = ssm_ops.bwd_shape_class(*args)
    assert (bp["kernel"], bp["d_inner"], bp["seq"], bp["n_state"], bp["batch"],
            bp["dtype"]) == ("ssm_scan_bwd", 16, 40, 16, 2, dtype)
    assert bp.fingerprint() != ssm_ops.shape_class(*args[:6]).fingerprint()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_bwd_registry_op_on_cpu_tensors(dtype):
    tdt = DTYPES[dtype][1]
    x, r, i, lam, dy = _rglru_inputs(12, 2, 40, 16)
    args = (_t(x, tdt), _t(r, tdt), _t(i, tdt), _t(lam), _t(dy, tdt))
    before = rg_mod.bwd_counter.plain_calls
    got = autotuned("rglru_scan_bwd")(*args)
    assert rg_mod.bwd_counter.plain_calls > before
    for g, w in zip(got, rg_mod.rglru_scan_bwd_plain(*args)):
        assert torch.equal(g, w)
    bp = rg_ops.bwd_shape_class(*args)
    assert (bp["kernel"], bp["width"], bp["seq"], bp["batch"], bp["dtype"]) == (
        "rglru_scan_bwd", 16, 40, 2, dtype)


def test_the_backward_ops_are_registered():
    for name in ("ssm_scan_bwd", "rglru_scan_bwd"):
        assert get_kernel(name).tags == ("cuda",)


# (d_inner, seq, n_state, batch): falcon-mamba-7b's width at B = 1, 2 and a
# short last chunk, state sizes off a power of two and past 32, short S
SSM_REGIONS = [(8192, 2048, 16, 1), (8192, 2048, 16, 2), (8192, 2047, 16, 1),
               (8192, 2048, 12, 1), (8192, 2048, 64, 1), (128, 64, 256, 1), (64, 7, 16, 2),
               (64, 1, 16, 1)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d_inner,seq,n_state,batch", SSM_REGIONS)
def test_ssm_bwd_emitted_points_launch(d_inner, seq, n_state, batch, dtype):
    """Every emitted point is one the kernel instantiates and takes: its
    (seg, channels, time lanes) compiled, whole warps of channel lanes
    within the launch bound for its (seg, channels), its shared memory
    within the card's opt-in limit; the wrapper's own check passes."""
    region = ssm_ops.ssm_bwd_region(d_inner, seq, n_state, batch, arch=SXM, dtype=dtype)
    points = list(region.space.points())
    assert points
    elt = 2 if dtype == "bfloat16" else 4
    for p in points:
        seg, ch = p["seg"], p["channels"]
        lanes_t = ssm_mod.bwd_group(p["chunk"], seg)
        assert lanes_t * seg == p["chunk"] and (seg, ch, lanes_t) in ssm_mod.BWD_TILES, p
        assert p["block_d"] % (32 // lanes_t * ch) == 0, p  # whole warps of channel lanes
        threads = ssm_mod.bwd_threads(p["block_d"], p["chunk"], seg, ch)
        assert threads == p["block_d"] // ch * lanes_t, p
        assert threads % 32 == 0 and threads <= ssm_mod.bwd_max_threads(seg, ch), p
        assert d_inner % p["block_d"] == 0, p
        assert ssm_mod.bwd_refusal(d_inner, **p) is None, p
        assert ssm_mod.bwd_smem_bytes(p["block_d"], p["chunk"], n_state, seg, ch, elt) <= (
            SXM.smem_per_block)
    tdt = DTYPES[dtype][1]
    x = torch.zeros((batch, seq, d_inner), dtype=tdt)
    A, Bc = torch.zeros((d_inner, n_state)), torch.zeros((batch, seq, n_state), dtype=tdt)
    for p in points[:4]:
        ssm_mod._bwd_check(x, x, A, Bc, Bc, torch.zeros(d_inner), x, None, **p)


RGLRU_REGIONS = [(2560, 2048, 1), (2560, 2048, 2), (2560, 2047, 1), (24, 7, 2), (24, 1, 2)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width,seq,batch", RGLRU_REGIONS)
def test_rglru_bwd_emitted_points_launch(width, seq, batch, dtype):
    region = rg_ops.rglru_bwd_region(width, seq, batch, arch=SXM, dtype=dtype)
    points = list(region.space.points())
    assert points
    elt = 2 if dtype == "bfloat16" else 4
    for p in points:
        assert rg_mod.seg_len(min(p["chunk"], seq), p["split"]) in rg_mod.SEGMENTS, p
        assert rg_mod.takes_split(min(p["chunk"], seq), p["split"]), p
        assert p["block_w"] * p["split"] <= rg_mod.bwd_max_threads(min(p["chunk"], seq),
                                                                  p["split"])
        assert width % p["block_w"] == 0, p
        assert rg_mod.bwd_smem_bytes(p["block_w"], p["chunk"], p["split"], elt) <= (
            SXM.smem_per_block)
    tdt = DTYPES[dtype][1]
    x = torch.zeros((batch, seq, width), dtype=tdt)
    for p in points[:4]:
        rg_mod._bwd_check(x, x, x, torch.zeros(width), x, **p)


def test_bwd_smem_and_scratch_models_count_the_sources_regions():
    # ssm at the train cell's (block_d, chunk, seg, channels) = (128, 32, 8, 2),
    # float32: 4 time lanes x 8 channel lanes a warp, 8 warps (256 threads);
    # in floats: B_t and C_t (16 rows of 32 + 4 steps), A, the start state,
    # the carry and the dA sums (16 x 128 each), the warps' dB/dC sums (8 x 2
    # x 16 rows of 32 + 1), the warps' transposes (8 x 2 x 8 x 32), the next
    # trip's x, dt, dy rows (3 x 32 x 128), B_t, C_t rows (2 x 32 x 16) and
    # start state (16 x 128), each thread's x and dskip terms (256 x 9 x 2)
    assert ssm_mod.bwd_smem_bytes(128, 32, 16, 8, 2, 4) == 4 * (
        2 * 16 * 36 + 4 * 16 * 128 + 8 * 2 * 16 * 33 + 8 * 2 * 8 * 32 + 3 * 32 * 128
        + 2 * 32 * 16 + 16 * 128 + 256 * 9 * 2) == 167_424
    # bf16: the prefetched rows at 2 bytes; N = 256 stages B_t, C_t when its
    # trip starts (no rows fetched ahead)
    assert ssm_mod.bwd_smem_bytes(128, 32, 16, 8, 2, 2) == (
        167_424 - 2 * (3 * 32 * 128 + 2 * 32 * 16))
    # (one warp: 4 time lanes x 8 channel lanes)
    assert ssm_mod.bwd_smem_bytes(8, 32, 256, 8, 1, 4) == 4 * (
        2 * 256 * 36 + 4 * 256 * 8 + 2 * 256 * 33 + 16 * 32 + 3 * 32 * 8 + 256 * 8 + 32 * 9)
    # the train cell (2, 2048, 8192, 16) at block_d 128, chunk 32: the states
    # at the start of trips 1..63, the dB partials (64 CTAs a batch row) in
    # the room of the trips' dt sums, the dC partials, dA's and dD's rows;
    # below the 135,331,840 bytes of the design before
    assert ssm_mod.bwd_scratch_bytes(2, 2048, 8192, 16, 128, 32) == 4 * (
        2 * 63 * 16 * 8192 + 2 * 2 * 64 * 2048 * 16 + 2 * 8192 * 16 + 2 * 8192) == 100_728_832
    # the dt sums larger than the dB partials (N = 1); one trip: no states
    assert ssm_mod.bwd_scratch_bytes(1, 2048, 64, 1, 64, 32) == 4 * (
        63 * 64 + 63 * 64 + 2048 + 64 + 64)
    assert ssm_mod.bwd_scratch_bytes(1, 7, 64, 16, 8, 32) == 4 * (
        2 * 8 * 7 * 16 + 64 * 16 + 64)
    # rglru: one trip's x, r, i and dy tiles, a CTA a trip
    # (4 segments of 32 rows of 128 channels and 8 elements of bank padding)
    assert rg_mod.bwd_smem_bytes(128, 128, 4, 4) == 4 * 4 * 4 * (32 * 128 + 8)
    # four (B, trips, W) arrays: the trips' a_t products, forward maps (then
    # start states), adjoint maps (then carries) and dlam partials
    assert rg_mod.bwd_scratch_bytes(2, 2047, 2560, 256) == 4 * 4 * (2 * 8 * 2560)


def test_backward_regions_rank_on_cpu_host():
    """On the CPU the registry builds the same spaces for CPU_HOST, with
    the backward's tunables; its finals run the plain version."""
    points = list(ssm_ops.ssm_bwd_region(64, 7, 16, 2, arch=CPU_HOST).space.points())
    assert points and all(set(p) == {"block_d", "chunk", "seg", "channels"} for p in points)
    assert all(ssm_mod.bwd_refusal(64, **p) is None for p in points)
    assert list(rg_ops.rglru_bwd_region(24, 7, 2, arch=CPU_HOST).space.points())


# -- the model, one train step ---------------------------------------------------


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-2b"])
def test_train_step_through_the_functions_matches_jax(arch, monkeypatch):
    """The SMOKE config's step with its scans on the kernel route's
    Functions (``on_kernel`` true for CPU tensors: the registry ops resolve
    on CPU tensors and run the plain forward and backward) equals the JAX
    step."""
    monkeypatch.setattr(ssm, "on_kernel", lambda t: True)
    monkeypatch.setattr(rglru, "on_kernel", lambda t: True)
    counter = ssm_mod.bwd_counter if arch == "falcon-mamba-7b" else rg_mod.bwd_counter
    before = counter.plain_calls
    check_train_step_matches_jax(arch)
    assert counter.plain_calls > before


@pytest.mark.parametrize("arch,kernel", [("falcon-mamba-7b", "ssm_scan_bwd"),
                                         ("recurrentgemma-2b", "rglru_scan_bwd")])
def test_a_second_trainer_recalls_the_backward_classes(arch, kernel, monkeypatch, tmp_path):
    """The Trainer's inline-tuning rule resolves the backward op on its
    TuningDB (routed through the Functions, as on the card), and a second
    Trainer on the same DB recalls every class with 0 evaluations."""
    from repro_torch.core import TuningDB
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import Trainer, TrainLoopConfig

    monkeypatch.setattr(ssm, "on_kernel", lambda t: True)
    monkeypatch.setattr(rglru, "on_kernel", lambda t: True)
    cfg = get_config(arch, smoke=True)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2)
    loop = TrainLoopConfig(total_steps=2, n_microbatches=1, microbatch_candidates=(1,))
    ds = SyntheticLMDataset(cfg, global_batch=2, seq_len=16, seed=0)
    db = str(tmp_path / "db.json")
    first = Trainer(cfg, opt, loop, tuning_db=TuningDB(db), device="cpu")
    first.run(ds)
    kernels = {st.bp["kernel"] for st in first.rule.states().values()}
    assert kernel in kernels and kernel[:-4] in kernels
    second = Trainer(cfg, opt, loop, tuning_db=TuningDB(db), device="cpu")
    second.run(ds)
    states = second.rule.states().values()
    assert {st.bp["kernel"] for st in states} == kernels
    assert sum(st.cost_evaluations for st in states) == 0


def test_the_trainers_leave_the_registry_as_they_found_it():
    """A Trainer registers ``train_step/<arch>`` in the port's registry; the
    autouse ``restore_port_registry`` takes it out again when the test that
    built it ends, so the tests above leave the package's own names alone
    (``test_torch_slice.py`` pins them)."""
    from repro_torch.core import kernel_names

    assert not [n for n in kernel_names() if n.startswith("train_step/")]
    assert set(kernel_names()) == {"exb", "flash_attention", "stress", "ssm_scan", "rglru_scan",
                                   "flash_attention_bwd", "ssm_scan_bwd", "rglru_scan_bwd"}
