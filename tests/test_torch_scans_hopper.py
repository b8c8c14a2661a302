"""The scans redesigned for Hopper: bf16 inputs, the new tunables, the
hints, and the kernels' reassociated arithmetic, checked on the CPU.

* bf16 parity: the same numpy inputs, cast to bf16, go through the JAX
  kernels (Pallas in interpret mode) and the port's plain versions; both
  return bf16, equal within the bf16 tolerance ``(2e-2, 2e-2)`` (the
  port's ``DEFAULT_TOL`` for bf16, which ``chip_smoke.py`` holds the CUDA
  kernels to).
* Any sequence length: at S = 1, 2, 7 and 2001 every emitted point of
  both scans passes the wrappers' checks, the port matches the JAX kernel,
  and the registry loop tunes and recalls.
* The kernels' order of operations, written out in numpy: the RG-LRU
  scan split across ``split`` threads a channel (segments composed with a
  Kogge-Stone scan, then rerun; the steps past a short tile read as the
  identity) at recurrentgemma-2b width, and the
  selective scan's exp through ``2^(dt A log2 e)`` with its per-lane
  partial sums and reduce-scatter.  Each must match the plain version
  within the scans' float32 tolerance ``(1e-4, 1e-4)`` before the kernels
  meet the card.
* The hints of one point of each scan, computed by hand.
"""
from __future__ import annotations

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru_scan import ops as jax_rg_ops
from repro.kernels.ssm_scan import ops as jax_ssm_ops
import repro_torch.core as tcore
from repro_torch import carry
from repro_torch.core.arch import CPU_HOST
from repro_torch.core.emit import TileDim, TilePolicy
from repro_torch.kernels.rglru_scan import ops as rg_ops
from repro_torch.kernels.rglru_scan import rglru_scan as rg_mod
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.kernels.ssm_scan import ssm_scan as ssm_mod
from test_torch_scans import TOL as SCAN_TOL, rglru_numpy, ssm_numpy

BF16_TOL = (2e-2, 2e-2)  # (rtol, atol), chip_smoke.TOL["bfloat16"]


def _bf16(arrays, f32_slots):
    """The arrays as bf16 numpy arrays (ml_dtypes), those in f32_slots kept
    float32."""
    return [a if n in f32_slots else np.asarray(jnp.asarray(a, jnp.bfloat16))
            for n, a in enumerate(arrays)]


def _close(port, ref, tol, label):
    np.testing.assert_allclose(carry.to_numpy(port), np.asarray(ref, np.float32),
                               rtol=tol[0], atol=tol[1], err_msg=label)


@pytest.mark.parametrize("point", [(8, 32, 1), (32, 64, 2), (128, 64, 4)])
def test_ssm_scan_bf16_matches_jax_kernel(point):
    arrays = _bf16(ssm_numpy(seed=61), f32_slots=(2, 5))  # A and D stay float32
    bd, ck, k = point
    ref = jax_ssm_ops.scan(*(jnp.asarray(a) for a in arrays), block_d=bd, chunk=ck)
    assert ref.dtype == jnp.bfloat16
    args = carry.ssm_inputs(*arrays, device="cpu")
    assert [t.dtype for t in args] == [torch.bfloat16, torch.bfloat16, torch.float32,
                                       torch.bfloat16, torch.bfloat16, torch.float32]
    out = ssm_mod.ssm_scan(*args, block_d=bd, chunk=ck, states=k)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == arrays[0].shape
    _close(out, ref, BF16_TOL, f"ssm_scan bf16 {point}")


@pytest.mark.parametrize("point", [(32, 32, 1), (64, 64, 8), (16, 64, 16)])
def test_rglru_scan_bf16_matches_jax_kernel(point):
    arrays = _bf16(rglru_numpy(seed=62), f32_slots=(3,))  # lam stays float32
    bw, ck, sp = point
    ref = jax_rg_ops.scan(*(jnp.asarray(a) for a in arrays), block_w=bw, chunk=ck)
    assert ref.dtype == jnp.bfloat16
    args = carry.rglru_inputs(*arrays, device="cpu")
    assert [t.dtype for t in args] == [torch.bfloat16] * 3 + [torch.float32]
    out = rg_mod.rglru_scan(*args, block_w=bw, chunk=ck, split=sp)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == arrays[0].shape
    _close(out, ref, BF16_TOL, f"rglru_scan bf16 {point}")


@pytest.mark.parametrize("slot", ["x", "dt", "Bc", "Cc"])
def test_ssm_scan_rejects_mixed_input_dtypes(slot):
    args = dict(zip(("x", "dt", "A", "Bc", "Cc", "D"),
                    carry.ssm_inputs(*ssm_numpy(seed=63), device="cpu")))
    args[slot] = args[slot].to(torch.bfloat16)
    with pytest.raises(ValueError, match="share one dtype, got mixed"):
        ssm_mod.ssm_scan(*args.values(), block_d=32, chunk=32)


@pytest.mark.parametrize("slot", ["x", "r", "i"])
def test_rglru_scan_rejects_mixed_input_dtypes(slot):
    args = dict(zip(("x", "r", "i", "lam"),
                    carry.rglru_inputs(*rglru_numpy(seed=64), device="cpu",
                                       dtype=torch.bfloat16)))
    args[slot] = args[slot].float()
    with pytest.raises(ValueError, match="share one dtype, got mixed"):
        rg_mod.rglru_scan(*args.values(), block_w=32, chunk=32)


def test_wrappers_reject_states_and_splits_the_kernels_do_not_take():
    ssm = carry.ssm_inputs(*ssm_numpy(seed=65, N=16), device="cpu")  # D = 128
    for states in (3, 6, 0):
        with pytest.raises(ValueError, match="states"):
            ssm_mod.ssm_scan(*ssm, block_d=32, chunk=32, states=states)
    with pytest.raises(ValueError, match="not a multiple of the 32 steps"):
        ssm_mod.ssm_scan(*ssm, block_d=32, chunk=16, states=1)
    rg = carry.rglru_inputs(*rglru_numpy(seed=66), device="cpu")  # S = 64, W = 128
    # not a power of two, 2-step segments, 2-step segments, over a warp
    for split, chunk in ((6, 64), (2, 4), (32, 64), (128, 64)):
        with pytest.raises(ValueError, match="split"):
            rg_mod.rglru_scan(*rg, block_w=32, chunk=chunk, split=split)


def test_ssm_hint_counts_warp_steps_and_the_sfu():
    region = ssm_ops.ssm_region(8192, 2048, 16, 1, arch=CPU_HOST)
    hint = region.hints[tcore.pp_key({"block_d": 64, "chunk": 128, "states": 4})]
    # 128 CTAs of 64 channels, 4 threads a channel: 256 threads, 8 warps on
    # each of 128 SMs; 2048 * 8192 * 4 / 32 warp-steps of 4 states each
    warp_steps = 2048 * 8192 * 4 / 32
    steps_s = warp_steps * (9.9e-9 + 4 * 3.1e-10) / 128
    sfu_s = 2048 * 8192 * 16 / (67e12 / 16) * 132 / 128  # one ex2 per (t, d, n)
    assert hint["latency_s"] == pytest.approx(steps_s, rel=1e-9)
    assert steps_s > sfu_s
    bytes_ = 4 * (3 * 2048 * 8192 + 2 * 2048 * 16) + 4 * (8192 * 16 + 8192)
    assert hint["bytes"] == bytes_
    assert hint["est_s"] == pytest.approx(3e-6 + steps_s, rel=1e-9)  # one wave
    # bf16 halves the streamed bytes; the warp-steps and the SFU do not move
    bf16 = ssm_ops.ssm_region(8192, 2048, 16, 1, arch=CPU_HOST, dtype="bfloat16")
    h16 = bf16.hints[tcore.pp_key({"block_d": 64, "chunk": 128, "states": 4})]
    assert h16["bytes"] == 2 * (3 * 2048 * 8192 + 2 * 2048 * 16) + 4 * (8192 * 16 + 8192)
    assert h16["latency_s"] == hint["latency_s"]
    # 16 states a thread: 32 CTAs of 256 channels, one thread each, fill 32
    # SMs, where the SFU's share of the exps outlasts the warp-steps
    h = region.hints[tcore.pp_key({"block_d": 256, "chunk": 32, "states": 16})]
    steps_s = 2048 * 8192 / 32 * (9.9e-9 + 16 * 3.1e-10) / 32
    sfu_s = 2048 * 8192 * 16 / (67e12 / 16) * 132 / 32
    assert sfu_s > steps_s
    assert h["latency_s"] == pytest.approx(sfu_s, rel=1e-9)


def test_rglru_hint_counts_the_chain_and_narrow_rows():
    region = rg_ops.rglru_region(2560, 2048, 1, arch=CPU_HOST)
    hint = region.hints[tcore.pp_key({"block_w": 32, "chunk": 256, "split": 8})]
    # 80 CTAs: a chain of 2 * 2048 / 8 steps and 8 tiles of log2(8) combines
    # (3 steps each) at 10 ns a step, plus 8 tiles at 0.6 us
    chain = (2 * 2048 / 8 + 8 * 3 * 3) * 10e-9 + 8 * 0.6e-6
    assert hint["latency_s"] == pytest.approx(chain, rel=1e-9)
    bytes_ = 4 * 4 * 2048 * 2560 + 4 * 2560  # 128-byte rows: no atom is wasted
    assert hint["bytes"] == bytes_
    assert hint["est_s"] == pytest.approx(3e-6 + bytes_ / 3.35e12 / (80 / 132), rel=1e-9)
    # one thread a channel: the whole sequence is the chain
    h = region.hints[tcore.pp_key({"block_w": 32, "chunk": 32, "split": 1})]
    chain = 2 * 2048 * 10e-9 + 64 * 0.6e-6
    assert h["latency_s"] == pytest.approx(chain, rel=1e-9)
    assert h["est_s"] == pytest.approx(3e-6 + chain, rel=1e-9)
    # bf16 rows of 16 channels are 32 bytes: the memory reads 64
    bf16 = rg_ops.rglru_region(2560, 2048, 1, arch=CPU_HOST, dtype="bfloat16")
    h = bf16.hints[tcore.pp_key({"block_w": 16, "chunk": 128, "split": 8})]
    assert h["bytes"] == 2 * (2 * 4 * 2048 * 2560 + 4 * 2560)


def _rglru_split_numpy(x, r, i, lam, chunk, split):
    """The RG-LRU scan as the kernel reassociates it, in float32: per tile
    of ``chunk`` steps (the last one may be short), ``split`` segments of L
    steps composed into maps (A, H), the steps past the tile's end read
    as x = r = i = 0, an inclusive Kogge-Stone scan of the maps, each
    segment rerun from its start state; vectorised over the channels."""
    f32 = np.float32
    B, S, W = x.shape
    L = rg_mod.seg_len(chunk, split)
    splam = np.logaddexp(-lam.astype(np.float64), 0.0).astype(f32)
    k2 = (f32(-8.0) * splam * f32(math.log2(math.e))).astype(f32)
    y = np.empty_like(x)
    for b in range(B):
        carry_ = np.zeros(W, f32)
        for t0 in range(0, S, chunk):
            n = min(chunk, S - t0)

            def seg(v):
                tile = np.zeros((split * L, W), f32)
                tile[:n] = v[b, t0:t0 + n]
                return tile.reshape(split, L, W)

            xs, rs, is_ = seg(x), seg(r), seg(i)
            a = np.exp2(rs * k2).astype(f32)
            gain = np.sqrt(np.maximum(f32(1.0) - a * a, f32(1e-12))).astype(f32)
            bb = (gain * (is_ * xs)).astype(f32)
            A = np.ones((split, W), f32)
            H = np.zeros((split, W), f32)
            for j in range(L):  # phase A: each segment's map from h = 0
                H = (a[:, j] * H + bb[:, j]).astype(f32)
                A = (A * a[:, j]).astype(f32)
            off = 1
            while off < split:  # phase B: inclusive scan over the segments
                Hp, Ap = H.copy(), A.copy()
                H[off:] = (A[off:] * Hp[:-off] + H[off:]).astype(f32)
                A[off:] = (A[off:] * Ap[:-off]).astype(f32)
                off *= 2
            Ae = np.concatenate([np.ones((1, W), f32), A[:-1]])
            He = np.concatenate([np.zeros((1, W), f32), H[:-1]])
            h = (Ae * carry_ + He).astype(f32)
            carry_ = (A[-1] * carry_ + H[-1]).astype(f32)
            out = np.empty((split, L, W), f32)
            for j in range(L):  # phase C: rerun from each segment's start
                h = (a[:, j] * h + bb[:, j]).astype(f32)
                out[:, j] = h
            y[b, t0:t0 + n] = out.reshape(split * L, W)[:n]
    return y


# (S, chunk, split): whole tiles; a short last tile; segments longer than
# chunk / split (L = 4 for 7 / 2), a lone short tile
@pytest.mark.parametrize("S,chunk,split", [(2048, 256, 8), (2048, 1024, 32), (2047, 256, 8),
                                           (2001, 56, 2), (7, 7, 2), (1, 1, 1)])
def test_rglru_split_scan_fits_the_tolerance_at_recurrentgemma_width(S, chunk, split):
    # the recurrence is causal: a shorter S is a prefix of the S = 2048 case
    (x, r, i, lam), plain = _recurrentgemma_case()
    x, r, i = (v[:, :S] for v in (x, r, i))
    ours = _rglru_split_numpy(x, r, i, lam, chunk, split)
    np.testing.assert_allclose(ours, plain[:, :S], rtol=SCAN_TOL[0], atol=SCAN_TOL[1])


@functools.lru_cache(maxsize=1)
def _recurrentgemma_case():
    """Inputs at recurrentgemma-2b width, S = 2048, and the plain version's
    output, computed once for every case above."""
    arrays = rglru_numpy(seed=67, B=1, S=2048, W=2560)
    plain = rg_mod.rglru_scan_plain(*carry.rglru_inputs(*arrays, device="cpu"))
    return arrays, plain.numpy()


def _ssm_grouped_numpy(x, dt, A, Bc, Cc, D, states):
    """The selective scan as the kernel orders it, in float32: the decay as
    2^(dt (A log2 e)), each lane's partial y over its ``states`` states,
    and the sum over a channel's N / states lanes as the reduce-scatter's
    pairs (the farthest lanes first)."""
    f32 = np.float32
    Bsz, S, Dd = x.shape
    N = A.shape[1]
    tpc = N // states
    a2 = (A * f32(math.log2(math.e))).astype(f32)
    y = np.empty_like(x)
    for b in range(Bsz):
        h = np.zeros((Dd, N), f32)
        for t in range(S):
            dtv, xv = dt[b, t][:, None], x[b, t]
            h = (np.exp2((dtv * a2).astype(f32)) * h
                 + ((dt[b, t] * xv).astype(f32)[:, None] * Bc[b, t][None, :])).astype(f32)
            prod = (h * Cc[b, t][None, :]).astype(f32).reshape(Dd, tpc, states)
            lanes = np.zeros((Dd, tpc), f32)
            for j in range(states):
                lanes = (lanes + prod[:, :, j]).astype(f32)
            while lanes.shape[1] > 1:
                half = lanes.shape[1] // 2
                lanes = (lanes[:, :half] + lanes[:, half:]).astype(f32)
            y[b, t] = (lanes[:, 0] + (xv * D).astype(f32)).astype(f32)
    return y


@pytest.mark.parametrize("states", [1, 4, 16])
def test_ssm_grouped_scan_fits_the_tolerance(states):
    arrays = ssm_numpy(seed=68, B=1, S=2048, D=64, N=16)
    ours = _ssm_grouped_numpy(*arrays, states)
    plain = ssm_mod.ssm_scan_plain(*carry.ssm_inputs(*arrays, device="cpu"))
    np.testing.assert_allclose(ours, plain.numpy(), rtol=SCAN_TOL[0], atol=SCAN_TOL[1])


def _banks(block_w, seg_len, split, elt):
    """The banks of the 32-bit words a warp's lanes read in one step of
    phase A, one set per lane group of a channel (distinct words only)."""
    pad = rg_mod.seg_pad(block_w, seg_len, split, elt)
    seg = seg_len * block_w + pad
    words = {}
    for lane in range(32):
        c, p = lane // split, lane % split
        word = (p * seg + c) * elt // 4  # step j = 0 of segment p, channel c
        words.setdefault(word % 32, set()).add(word)
    return words


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_segment_padding_puts_each_lane_on_its_own_bank(dtype):
    """Every emitted point at recurrentgemma-2b width: in a warp, two lanes
    on one bank read one word (a broadcast), never two."""
    elt = rg_mod.DTYPES[getattr(torch, dtype)]
    region = rg_ops.rglru_region(2560, 2048, 1, arch=CPU_HOST, dtype=dtype)
    for p in region.space.points():
        bw, split = p["block_w"], p["split"]
        if bw * split < 32 or bw < 32 // split:
            continue
        for bank, words in _banks(bw, p["chunk"] // split, split, elt).items():
            assert len(words) == 1, (p, bank, words)
        seg = p["chunk"] // split * bw + rg_mod.seg_pad(bw, p["chunk"] // split, split, elt)
        assert rg_mod.smem_bytes(bw, p["chunk"], split, elt) == 6 * -(-split * seg * elt // 16) * 16


def test_point_filter_keeps_only_what_the_kernel_takes():
    policy = TilePolicy(
        kernel="toy",
        dims=lambda bp: (TileDim("a", 64, semantic="grid", min_tile=1),
                         TileDim("b", 64, semantic="sequential", min_tile=1)),
        vmem_model=lambda bp, p: 0,
        point_filter=lambda bp, p: p["a"] * p["b"] == 64,
    )
    points = list(policy.emit(CPU_HOST, {}).space.points())
    assert points and all(p["a"] * p["b"] == 64 for p in points)
    unfiltered = TilePolicy(kernel="toy", dims=policy.dims, vmem_model=lambda bp, p: 0)
    assert len(list(unfiltered.emit(CPU_HOST, {}).space.points())) > len(points)


@pytest.mark.parametrize("name", ["ssm_scan", "rglru_scan"])
def test_bf16_tunes_a_shape_class_of_its_own_and_recalls_it(name, tmp_path):
    if name == "ssm_scan":
        f32 = carry.ssm_inputs(*ssm_numpy(seed=69), device="cpu")
        bf16 = carry.ssm_inputs(*ssm_numpy(seed=69), device="cpu", dtype=torch.bfloat16)
        mod = ssm_mod
    else:
        f32 = carry.rglru_inputs(*rglru_numpy(seed=70), device="cpu")
        bf16 = carry.rglru_inputs(*rglru_numpy(seed=70), device="cpu", dtype=torch.bfloat16)
        mod = rg_mod
    path = str(tmp_path / "db.json")
    cold = tcore.autotuned(name, db=tcore.TuningDB(path))
    cold(*f32)
    out = cold(*bf16)
    assert out.dtype == torch.bfloat16
    f32_state, bf16_state = cold.resolve(*f32), cold.resolve(*bf16)
    assert bf16_state.bp["dtype"] == "bfloat16" and bf16_state.cost_evaluations > 0
    assert bf16_state.bp.fingerprint() != f32_state.bp.fingerprint()
    mod.counter.reset()
    fresh = tcore.autotuned(name, db=tcore.TuningDB(path))
    fresh(*bf16)
    recall = fresh.resolve(*bf16)
    assert recall.cost_evaluations == 0 and recall.from_cache
    assert recall.region.selected == bf16_state.region.selected
    assert mod.counter.launches == 0 and mod.counter.plain_calls > 0  # CPU tensors


# S: one step (decode), two, an odd length, and one with no power-of-two
# factor (3 * 23 * 29); the JAX kernel takes a chunk that divides S
@pytest.mark.parametrize("S,jax_chunk", [(1, 1), (2, 2), (7, 7), (2001, 87)])
def test_ssm_scan_takes_any_length_and_matches_jax_kernel(S, jax_chunk):
    arrays = ssm_numpy(seed=71, B=2, S=S, D=64, N=16)
    ref = jax_ssm_ops.scan(*(jnp.asarray(a) for a in arrays), block_d=32, chunk=jax_chunk)
    args = carry.ssm_inputs(*arrays, device="cpu")
    region = ssm_ops.ssm_region(64, S, 16, 2, arch=CPU_HOST)
    points = list(region.space.points())
    assert points
    for p in points:
        ssm_mod._check(*args, p["block_d"], p["chunk"], p["states"])
    out = ssm_mod.ssm_scan(*args, **points[0])
    _close(out, ref, SCAN_TOL, f"ssm_scan S={S} {points[0]}")


@pytest.mark.parametrize("S,jax_chunk", [(1, 1), (2, 2), (7, 7), (2001, 87)])
def test_rglru_scan_takes_any_length_and_matches_jax_kernel(S, jax_chunk):
    arrays = rglru_numpy(seed=72, B=2, S=S, W=24)
    ref = jax_rg_ops.scan(*(jnp.asarray(a) for a in arrays), block_w=24, chunk=jax_chunk)
    args = carry.rglru_inputs(*arrays, device="cpu")
    points = list(rg_ops.rglru_region(24, S, 2, arch=CPU_HOST).space.points())
    assert points
    for p in points:
        rg_mod._check(*args, p["block_w"], p["chunk"], p["split"])
    out = rg_mod.rglru_scan(*args, **points[0])
    _close(out, ref, SCAN_TOL, f"rglru_scan S={S} {points[0]}")


def test_wrappers_take_chunks_and_ctas_the_jax_kernels_do_not():
    """A chunk that does not divide S (the last trip is short) and an
    RG-LRU CTA of less than a warp (its lanes shuffle among themselves)."""
    arrays = ssm_numpy(seed=73, S=40)
    ref = jax_ssm_ops.scan(*(jnp.asarray(a) for a in arrays), block_d=8, chunk=40)
    out = ssm_mod.ssm_scan(*carry.ssm_inputs(*arrays, device="cpu"), block_d=8, chunk=32)
    _close(out, ref, SCAN_TOL, "ssm_scan chunk 32 at S=40")
    arrays = rglru_numpy(seed=74)  # S = 64, W = 128
    ref = jax_rg_ops.scan(*(jnp.asarray(a) for a in arrays), block_w=8, chunk=64)
    args = carry.rglru_inputs(*arrays, device="cpu")
    for bw, chunk, split in ((32, 24, 1), (8, 32, 2), (8, 7, 2)):  # 16 threads a CTA
        _close(rg_mod.rglru_scan(*args, block_w=bw, chunk=chunk, split=split), ref, SCAN_TOL,
               f"rglru_scan ({bw},{chunk},{split}) at S=64")


@pytest.mark.parametrize("name", ["ssm_scan", "rglru_scan"])
@pytest.mark.parametrize("S", [1, 7])
def test_registry_tunes_and_recalls_short_sequences(name, S, tmp_path):
    if name == "ssm_scan":
        arrays = ssm_numpy(seed=75, B=2, S=S, D=64, N=16)
        args = carry.ssm_inputs(*arrays, device="cpu")
        ref = jax_ssm_ops.scan(*(jnp.asarray(a) for a in arrays), block_d=32, chunk=S)
    else:
        arrays = rglru_numpy(seed=76, B=2, S=S, W=24)
        args = carry.rglru_inputs(*arrays, device="cpu")
        ref = jax_rg_ops.scan(*(jnp.asarray(a) for a in arrays), block_w=24, chunk=S)
    path = str(tmp_path / "db.json")
    cold = tcore.autotuned(name, db=tcore.TuningDB(path))
    _close(cold(*args), ref, SCAN_TOL, f"{name} S={S}")
    assert cold.resolve(*args).cost_evaluations > 0
    fresh = tcore.autotuned(name, db=tcore.TuningDB(path))
    _close(fresh(*args), ref, SCAN_TOL, f"{name} S={S} recalled")
    assert fresh.resolve(*args).cost_evaluations == 0
