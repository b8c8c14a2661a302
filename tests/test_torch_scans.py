"""Scan parity: the JAX package's ssm_scan and rglru_scan kernels and the
port's, on one input.

The same numpy inputs (``np.random.default_rng``, drawn as the JAX
``make_inputs`` draws them) go through the JAX wrappers (Pallas in
interpret mode, as the JAX tests run them on the CPU) and through the
port's wrappers on CPU tensors, which run the port's plain PyTorch
versions.  Tolerance: the scans' conformance tolerance, float32
``(1e-4, 1e-4)`` (``tests/conformance.py``).  The CUDA kernels themselves
are checked against the same plain versions on the card by
``chip_smoke.py``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformance import CASES
from repro.kernels.rglru_scan import ops as jax_rg_ops
from repro.kernels.ssm_scan import ops as jax_ssm_ops
from repro_torch import carry
from repro_torch.core.arch import CPU_HOST
from repro_torch.kernels.rglru_scan import ops as rg_ops
from repro_torch.kernels.rglru_scan import rglru_scan as rg_mod
from repro_torch.kernels.rglru_scan.ref import softplus
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.kernels.ssm_scan import ssm_scan as ssm_mod

TOL = (1e-4, 1e-4)  # (rtol, atol) float32, conformance "ssm_scan"/"rglru_scan"
# the slice shapes chip_smoke.py runs: falcon-mamba-7b and recurrentgemma-2b
SSM_SLICE = dict(B=1, S=2048, D=8192, N=16)
RGLRU_SLICE = dict(B=1, S=2048, W=2560)


def _softplus_np(v):
    return np.logaddexp(v, 0.0).astype(np.float32)


def ssm_numpy(seed: int, B=1, S=64, D=128, N=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D), np.float32)
    dt = _softplus_np(rng.standard_normal((B, S, D), np.float32) - 1.0)
    A = -np.exp(rng.standard_normal((D, N), np.float32) * 0.5).astype(np.float32)
    Bc = rng.standard_normal((B, S, N), np.float32)
    Cc = rng.standard_normal((B, S, N), np.float32)
    Dp = rng.standard_normal((D,), np.float32)
    return x, dt, A, Bc, Cc, Dp


def rglru_numpy(seed: int, B=1, S=64, W=128):
    rng = np.random.default_rng(seed)
    sig = lambda v: (1.0 / (1.0 + np.exp(-v))).astype(np.float32)
    x = rng.standard_normal((B, S, W), np.float32)
    r = sig(rng.standard_normal((B, S, W), np.float32))
    i = sig(rng.standard_normal((B, S, W), np.float32))
    u = rng.uniform(0.9, 0.999, (W,)).astype(np.float32)
    lam = np.log(u / (1 - u)).astype(np.float32)
    return x, r, i, lam


def assert_close(port, ref, label):
    np.testing.assert_allclose(carry.to_numpy(port), np.asarray(ref, np.float32),
                               rtol=TOL[0], atol=TOL[1], err_msg=label)


def test_tolerance_is_the_conformance_one():
    assert CASES["ssm_scan"].tol["float32"] == TOL
    assert CASES["rglru_scan"].tol["float32"] == TOL


# (block_d, chunk, states): N = 4, so 32, 64 and 128 threads
@pytest.mark.parametrize("point", [(8, 32, 1), (32, 64, 2), (128, 64, 4)])
def test_ssm_scan_matches_jax_kernel(point):
    arrays = ssm_numpy(seed=41)
    bd, ck, k = point
    ref = jax_ssm_ops.scan(*(jnp.asarray(a) for a in arrays), block_d=bd, chunk=ck)
    out = ssm_mod.ssm_scan(*carry.ssm_inputs(*arrays, device="cpu"), block_d=bd, chunk=ck,
                           states=k)
    assert out.dtype == torch.float32 and tuple(out.shape) == arrays[0].shape
    assert_close(out, ref, f"ssm_scan {point}")


@pytest.mark.parametrize("point", [(32, 32), (64, 64), (128, 64)])
def test_rglru_scan_matches_jax_kernel(point):
    arrays = rglru_numpy(seed=42)
    bw, ck = point
    ref = jax_rg_ops.scan(*(jnp.asarray(a) for a in arrays), block_w=bw, chunk=ck)
    out = rg_mod.rglru_scan(*carry.rglru_inputs(*arrays, device="cpu"),
                            block_w=bw, chunk=ck)
    assert out.dtype == torch.float32 and tuple(out.shape) == arrays[0].shape
    assert_close(out, ref, f"rglru_scan {point}")


@pytest.mark.parametrize("lam", [30.0, -30.0, 21.0, -21.0, 0.5, 0.0])
def test_softplus_has_no_threshold(lam):
    """The plain version's softplus(-λ) is jax.nn.softplus, at both ends."""
    v = np.array([-lam], np.float32)
    ours = softplus(torch.from_numpy(v))
    theirs = np.asarray(jax.nn.softplus(jnp.asarray(v)))
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-6, atol=0)
    assert float(ours[0]) > 0.0


def test_cpu_tensors_take_the_plain_version_and_count_it():
    ssm_mod.counter.reset()
    ssm_mod.ssm_scan(*carry.ssm_inputs(*ssm_numpy(seed=43), device="cpu"),
                     block_d=16, chunk=32)
    assert (ssm_mod.counter.launches, ssm_mod.counter.plain_calls) == (0, 1)
    rg_mod.counter.reset()
    rg_mod.rglru_scan(*carry.rglru_inputs(*rglru_numpy(seed=44), device="cpu"),
                      block_w=32, chunk=32)
    assert (rg_mod.counter.launches, rg_mod.counter.plain_calls) == (0, 1)


def test_ssm_wrapper_rejects_what_the_kernel_does_not_take():
    args = carry.ssm_inputs(*ssm_numpy(seed=45), device="cpu")
    x, dt, A, Bc, Cc, D = args
    with pytest.raises(ValueError, match="must divide"):
        ssm_mod.ssm_scan(*args, block_d=48, chunk=32)
    with pytest.raises(ValueError, match="not a multiple of the 32 steps"):
        ssm_mod.ssm_scan(*args, block_d=8, chunk=48)
    with pytest.raises(ValueError, match="threads"):
        ssm_mod.ssm_scan(*args, block_d=4, chunk=32)     # 16 threads: half a warp
    with pytest.raises(ValueError, match="Bc"):
        ssm_mod.ssm_scan(x, dt, A, Bc[:, :32], Cc, D)
    with pytest.raises(ValueError, match="mixed"):
        ssm_mod.ssm_scan(x.to(torch.bfloat16), dt, A, Bc, Cc, D)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ssm_mod.ssm_scan(x.double(), dt.double(), A, Bc.double(), Cc.double(), D)
    with pytest.raises(ValueError, match="A must be float32"):
        ssm_mod.ssm_scan(x, dt, A.to(torch.bfloat16), Bc, Cc, D)
    with pytest.raises(ValueError, match="states 3"):
        ssm_mod.ssm_scan(*args, block_d=32, chunk=32, states=3)
    with pytest.raises(ValueError, match="threads"):
        ssm_mod.ssm_scan(*args, block_d=16, chunk=32, states=4)  # 16 threads
    n16 = carry.ssm_inputs(*ssm_numpy(seed=47, S=32, D=512, N=16), device="cpu")
    with pytest.raises(ValueError, match="up to 256"):
        ssm_mod.ssm_scan(*n16, block_d=256, chunk=32, states=8)  # 512 threads
    with pytest.raises(ValueError, match=r"N=300 outside 1\.\.256"):
        s300 = carry.ssm_inputs(*ssm_numpy(seed=46, S=32, D=32, N=300), device="cpu")
        ssm_mod.ssm_scan(*s300, block_d=32, chunk=32, states=16)
    with pytest.raises(ValueError, match="64 lanes a channel"):
        s64 = carry.ssm_inputs(*ssm_numpy(seed=46, S=32, D=32, N=64), device="cpu")
        ssm_mod.ssm_scan(*s64, block_d=1, chunk=32)
    big = carry.ssm_inputs(*ssm_numpy(seed=47, S=32, D=512, N=4), device="cpu")
    with pytest.raises(ValueError, match="threads"):
        ssm_mod.ssm_scan(*big, block_d=512, chunk=32)   # 2048 threads
    with pytest.raises(ValueError, match="shared"):
        wide = carry.ssm_inputs(*ssm_numpy(seed=48, S=2048, D=128, N=8), device="cpu")
        ssm_mod.ssm_scan(*wide, block_d=128, chunk=2048, states=8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssm_mod.ssm_scan_cuda(*args, block_d=8, chunk=32)


def test_rglru_wrapper_rejects_what_the_kernel_does_not_take():
    args = carry.rglru_inputs(*rglru_numpy(seed=49), device="cpu")
    x, r, i, lam = args
    with pytest.raises(ValueError, match="must divide"):
        rg_mod.rglru_scan(*args, block_w=48, chunk=32)
    with pytest.raises(ValueError, match="lam"):
        rg_mod.rglru_scan(x, r, i, lam[:64])
    with pytest.raises(ValueError, match=r"\br \("):
        rg_mod.rglru_scan(x, r[:, :32], i, lam)
    with pytest.raises(ValueError, match="mixed"):
        rg_mod.rglru_scan(x, r, i.double(), lam)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        rg_mod.rglru_scan(x.double(), r.double(), i.double(), lam)
    with pytest.raises(ValueError, match="lam must be float32"):
        rg_mod.rglru_scan(x, r, i, lam.to(torch.bfloat16))
    # not a power of two, a 2-step segment, over a warp, a 64-step segment
    for split, chunk in ((3, 64), (16, 32), (64, 64), (1, 64)):
        with pytest.raises(ValueError, match="split"):
            rg_mod.rglru_scan(*args, block_w=32, chunk=chunk, split=split)
    wide = carry.rglru_inputs(*rglru_numpy(seed=50, S=32, W=2048), device="cpu")
    with pytest.raises(ValueError, match="threads"):
        rg_mod.rglru_scan(*wide, block_w=2048, chunk=32)
    with pytest.raises(ValueError, match="shared"):
        rg_mod.rglru_scan(*carry.rglru_inputs(*rglru_numpy(seed=51, S=1024, W=256),
                                              device="cpu"),
                          block_w=16, chunk=1024, split=32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rg_mod.rglru_scan_cuda(*args, block_w=32, chunk=32)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the slice shapes' emitted ladders, the same in both dtypes: block_d per
# states (16 / states threads a channel, whole warps up to the launch
# bound: 512 threads, 256 at 8 and 16 states) and the chunks
SSM_SLICE_BLOCK_D = {1: {2, 4, 8, 16, 32}, 2: {4, 8, 16, 32, 64}, 4: {8, 16, 32, 64, 128},
                     8: {16, 32, 64, 128}, 16: {32, 64, 128, 256}}
# block_w and chunk per split: chunk / split in 4..32, block_w * split
# whole warps up to 512, block_w from a 16-byte row (4 float32 or 8 bf16
# channels) up to 128
RGLRU_SLICE_BLOCK_W = {
    "float32": {1: {32, 64, 128}, 2: {16, 32, 64, 128}, 4: {8, 16, 32, 64, 128},
                8: {4, 8, 16, 32, 64}, 16: {4, 8, 16, 32}, 32: {4, 8, 16}},
    "bfloat16": {1: {32, 64, 128}, 2: {16, 32, 64, 128}, 4: {8, 16, 32, 64, 128},
                 8: {8, 16, 32, 64}, 16: {8, 16, 32}, 32: {8, 16}},
}
RGLRU_SLICE_CHUNK = {1: {8, 16, 32}, 2: {8, 16, 32, 64}, 4: {16, 32, 64, 128},
                     8: {32, 64, 128, 256}, 16: {64, 128, 256, 512},
                     32: {128, 256, 512, 1024}}


# the slice widths at an odd length (a ragged last trip), and at S = 7
# (one chunk shorter than the groups of 32 / states steps)
SHAPES = {"ssm_scan": {"slice": SSM_SLICE, "conformance": dict(B=1, S=64, D=128, N=4),
                       "odd": dict(SSM_SLICE, B=4, S=2047), "short": dict(B=2, S=7, D=64, N=16)},
          "rglru_scan": {"slice": RGLRU_SLICE, "conformance": dict(B=1, S=64, W=128),
                         "odd": dict(RGLRU_SLICE, B=4, S=2047), "short": dict(B=2, S=7, W=24)}}


@pytest.mark.parametrize("shape", ["slice", "conformance", "odd", "short"])
def test_every_emitted_ssm_point_fits_the_kernel(shape):
    s = SHAPES["ssm_scan"][shape]
    B, S, D, N = s["B"], s["S"], s["D"], s["N"]
    for dtype_name, dtype in DTYPES.items():
        region = ssm_ops.ssm_region(D, S, N, B, arch=CPU_HOST, dtype=dtype_name)
        m = lambda *shape: _meta(*shape, dtype=dtype)  # noqa: E731
        args = (m(B, S, D), m(B, S, D), _meta(D, N), m(B, S, N), m(B, S, N), _meta(D))
        points = list(region.space.points())
        assert 1 < len(points) < 150
        for p in points:
            _, _, _, _, bd, ck, k = ssm_mod._check(*args, p["block_d"], p["chunk"],
                                                   p["states"])
            # no point is min'd
            assert (bd, ck, k) == (p["block_d"], p["chunk"], p["states"])
            threads = bd * N // k
            assert threads % 32 == 0 and threads <= ssm_mod.max_threads(k)
            elt = ssm_mod.DTYPES[dtype]
            assert ssm_mod.smem_bytes(bd, ck, N, elt) <= region.arch.smem_per_block
        if shape == "slice":
            ladders = {}
            for p in points:
                ladders.setdefault(p["states"], set()).add(p["block_d"])
            assert ladders == SSM_SLICE_BLOCK_D
        if shape in ("slice", "odd"):
            assert {p["chunk"] for p in points} == {32, 64, 128, 256}
        if shape == "short":
            assert {p["chunk"] for p in points} == {7}


@pytest.mark.parametrize("shape", ["slice", "conformance", "odd", "short"])
def test_every_emitted_rglru_point_fits_the_kernel(shape):
    s = SHAPES["rglru_scan"][shape]
    B, S, W = s["B"], s["S"], s["W"]
    for dtype_name, dtype in DTYPES.items():
        region = rg_ops.rglru_region(W, S, B, arch=CPU_HOST, dtype=dtype_name)
        args = (_meta(B, S, W, dtype=dtype), _meta(B, S, W, dtype=dtype),
                _meta(B, S, W, dtype=dtype), _meta(W))
        points = list(region.space.points())
        assert 1 < len(points) < 150
        for p in points:
            _, _, _, bw, ck, sp = rg_mod._check(*args, p["block_w"], p["chunk"], p["split"])
            assert (bw, ck, sp) == (p["block_w"], p["chunk"], p["split"])
            assert (bw * sp % 32 == 0 or bw == W) and bw * sp <= rg_mod.MAX_THREADS
            assert rg_mod.seg_len(ck, sp) in rg_mod.SEGMENTS
            assert bw * rg_mod.DTYPES[dtype] >= min(16, W * rg_mod.DTYPES[dtype])
            elt = rg_mod.DTYPES[dtype]
            assert rg_mod.smem_bytes(bw, ck, sp, elt) <= region.arch.smem_per_block
        if shape == "slice":
            block_w, chunk = {}, {}
            for p in points:
                block_w.setdefault(p["split"], set()).add(p["block_w"])
                chunk.setdefault(p["split"], set()).add(p["chunk"])
            assert block_w == RGLRU_SLICE_BLOCK_W[dtype_name]
            assert chunk == RGLRU_SLICE_CHUNK
        if shape == "short":
            assert {p["chunk"] for p in points} == {4, 7}


def test_batch_bucket_splits_shape_classes_and_counts_ctas():
    def ssm_bp(B):
        return ssm_ops.shape_class(*carry.ssm_inputs(*ssm_numpy(seed=52, B=B), device="cpu"))

    def rg_bp(B):
        return rg_ops.shape_class(*carry.rglru_inputs(*rglru_numpy(seed=53, B=B), device="cpu"))

    for bp in (ssm_bp, rg_bp):
        one, five, eight = bp(1), bp(5), bp(8)
        assert one["batch"] == 1 and eight["batch"] == 8
        assert one.fingerprint() != eight.fingerprint()
        assert five.fingerprint() == eight.fingerprint()  # bucketed to 8
    one = ssm_ops.ssm_region(128, 64, 4, 1, arch=CPU_HOST)
    eight = ssm_ops.ssm_region(128, 64, 4, 8, arch=CPU_HOST)
    for key, hint in one.hints.items():
        assert eight.hints[key]["programs"] == 8 * hint["programs"]
        assert eight.hints[key]["bytes"] == ssm_mod.traffic(8, 64, 128, 4)[1]
    one = rg_ops.rglru_region(128, 64, 1, arch=CPU_HOST)
    eight = rg_ops.rglru_region(128, 64, 8, arch=CPU_HOST)
    for key, hint in one.hints.items():
        assert eight.hints[key]["programs"] == 8 * hint["programs"]


def test_jax_shape_classes_drop_the_batch_the_port_keeps():
    x, dt, A, Bc, Cc, D = ssm_numpy(seed=54, B=2)
    jbp = jax_ssm_ops.shape_class(*(jnp.asarray(a) for a in (x, dt, A, Bc, Cc, D)))
    tbp = ssm_ops.shape_class(*carry.ssm_inputs(x, dt, A, Bc, Cc, D, device="cpu"))
    assert "batch" not in jbp.asdict() and tbp["batch"] == 2
    assert {k: tbp[k] for k in ("d_inner", "seq", "n_state", "dtype")} == {
        k: jbp[k] for k in ("d_inner", "seq", "n_state", "dtype")
    }
    x, r, i, lam = rglru_numpy(seed=55, B=2)
    jbp = jax_rg_ops.shape_class(*(jnp.asarray(a) for a in (x, r, i, lam)))
    tbp = rg_ops.shape_class(*carry.rglru_inputs(x, r, i, lam, device="cpu"))
    assert jbp.fingerprint() != tbp.fingerprint()
    assert tbp["framework"] == "torch" and tbp["batch"] == 2


def test_traffic_counts_the_whole_call():
    flops, bytes_ = ssm_mod.traffic(**SSM_SLICE)
    B, S, D, N = (SSM_SLICE[k] for k in ("B", "S", "D", "N"))
    assert bytes_ == 4 * (3 * B * S * D + 2 * B * S * N + D * N + D)
    assert flops == 7 * B * S * D * N + 3 * B * S * D
    _, bf16_bytes = ssm_mod.traffic(**SSM_SLICE, elt=2)
    assert bf16_bytes == 2 * (3 * B * S * D + 2 * B * S * N) + 4 * (D * N + D)
    flops, bytes_ = rg_mod.traffic(*(RGLRU_SLICE[k] for k in ("B", "S", "W")))
    assert bytes_ == 4 * (4 * 2048 * 2560 + 2560)
    _, bf16_bytes = rg_mod.traffic(*(RGLRU_SLICE[k] for k in ("B", "S", "W")), elt=2)
    assert bf16_bytes == 2 * 4 * 2048 * 2560 + 4 * 2560


def test_carry_keeps_layout_and_values():
    arrays = ssm_numpy(seed=56)
    for t, a in zip(carry.ssm_inputs(*arrays, device="cpu"), arrays):
        assert tuple(t.shape) == a.shape and t.dtype == torch.float32
        np.testing.assert_array_equal(carry.to_numpy(t), a)
    arrays = rglru_numpy(seed=57)
    for t, a in zip(carry.rglru_inputs(*arrays, device="cpu"), arrays):
        assert tuple(t.shape) == a.shape and t.is_contiguous()
        np.testing.assert_array_equal(carry.to_numpy(t), a)
    # bf16 arrays stay bf16 (values exact); A, D and lam stay float32
    bf16 = jnp.bfloat16
    for make, carrier, f32_slots in ((ssm_numpy, carry.ssm_inputs, (2, 5)),
                                     (rglru_numpy, carry.rglru_inputs, (3,))):
        arrays = [np.asarray(jnp.asarray(a, jnp.float32 if n in f32_slots else bf16))
                  for n, a in enumerate(make(seed=58))]
        for n, (t, a) in enumerate(zip(carrier(*arrays, device="cpu"), arrays)):
            want = torch.float32 if n in f32_slots else torch.bfloat16
            assert t.dtype == want and tuple(t.shape) == a.shape and t.is_contiguous()
            np.testing.assert_array_equal(carry.to_numpy(t), a.astype(np.float32))
        # a named dtype casts the scan inputs, never A, D or lam
        named = carrier(*make(seed=59), device="cpu", dtype=torch.bfloat16)
        assert [t.dtype for t in named] == [
            torch.float32 if n in f32_slots else torch.bfloat16 for n in range(len(named))]
