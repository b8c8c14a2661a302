"""Kernel parity: the JAX package's kernels and the port's, on one input.

The same numpy inputs (``np.random.default_rng``) go through the JAX
kernel wrapper (Pallas in interpret mode, as the JAX tests run it on the
CPU) and through the port's wrapper on CPU tensors, which runs the port's
plain PyTorch version.  Tolerances are ``tests/conformance.py``'s
``DEFAULT_TOL``.  The CUDA kernels themselves are checked against the same
plain versions on the card by ``chip_smoke.py``.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformance import DEFAULT_TOL
from repro.kernels.exb import ops as jax_exb_ops
from repro.kernels.flash_attention import ops as jax_fa_ops
from repro_torch import carry
from repro_torch.kernels import _build
from repro_torch.kernels.exb import exb as exb_mod
from repro_torch.kernels.exb import ops as exb_ops
from repro_torch.kernels.flash_attention import flash_attention as fa_mod
from repro_torch.kernels.flash_attention import ops as fa_ops

EXB_DIMS = (4, 4, 16, 9)


def exb_numpy(seed: int, dims=EXB_DIMS):
    iv, iz, mx, my = dims
    rng = np.random.default_rng(seed)
    out = {n: rng.standard_normal((iv, iz, mx, my), np.float32)
           for n in ("df1_re", "df1_im", "df2_re", "df2_im")}
    for n in ("ex_re", "ex_im", "ey_re", "ey_im", "bx_re", "bx_im", "by_re", "by_im"):
        out[n] = rng.standard_normal((iz, mx, my), np.float32)
    out["vl"] = rng.standard_normal((iv,), np.float32)
    return out


def qkv_numpy(seed: int, S: int, H: int = 2, KV: int = 1, hd: int = 16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, S, H, hd), np.float32),
            rng.standard_normal((1, S, KV, hd), np.float32),
            rng.standard_normal((1, S, KV, hd), np.float32))


def assert_close(port, ref, dtype: str, label: str) -> None:
    rtol, atol = DEFAULT_TOL[dtype]
    np.testing.assert_allclose(
        carry.to_numpy(port), np.asarray(ref, np.float32),
        rtol=rtol, atol=atol, err_msg=label,
    )


@pytest.mark.parametrize("point", [(1, 1), (2, 4), (4, 4)])
def test_exb_matches_jax_kernel(point):
    arrays = exb_numpy(seed=11)
    biv, biz = point
    ref_re, ref_im = jax_exb_ops.exb(
        {k: jnp.asarray(v) for k, v in arrays.items()}, block_iv=biv, block_iz=biz
    )
    out_re, out_im = exb_mod.exb(carry.exb_inputs(arrays, device="cpu"),
                                 block_iv=biv, block_iz=biz)
    assert_close(out_re, ref_re, "float32", f"exb re {point}")
    assert_close(out_im, ref_im, "float32", f"exb im {point}")


@pytest.mark.parametrize(
    "dtype,S,point",
    [
        ("float32", 256, (64, 128)),
        ("bfloat16", 256, (128, 64)),
        ("float32", 200, (64, 64)),   # padded tail: 200 is no multiple of 64
    ],
)
def test_flash_matches_jax_kernel(dtype, S, point):
    q, k, v = qkv_numpy(seed=5, S=S)
    bq, bkv = point
    jdt = jnp.dtype(dtype)
    ref = jax_fa_ops.attention(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)), block_q=bq, block_kv=bkv
    )
    tdt = getattr(torch, dtype)
    out = fa_mod.flash_attention(*carry.attention_inputs(q, k, v, device="cpu", dtype=tdt),
                                 block_q=bq, block_kv=bkv)
    assert out.dtype == tdt and tuple(out.shape) == q.shape
    assert_close(out, ref, dtype, f"flash {dtype} S={S} {point}")


def test_cpu_tensors_take_the_plain_version_and_count_it():
    inp = carry.exb_inputs(exb_numpy(seed=1), device="cpu")
    exb_mod.counter.reset()
    exb_mod.exb(inp, block_iv=2, block_iz=2)
    assert (exb_mod.counter.launches, exb_mod.counter.plain_calls) == (0, 1)
    q, k, v = carry.attention_inputs(*qkv_numpy(seed=2, S=32), device="cpu")
    fa_mod.counter.reset()
    fa_mod.flash_attention(q, k, v, block_q=16, block_kv=16)
    assert (fa_mod.counter.launches, fa_mod.counter.plain_calls) == (0, 1)


def test_wrappers_reject_what_the_kernel_does_not_take():
    inp = carry.exb_inputs(exb_numpy(seed=3), device="cpu")
    with pytest.raises(ValueError, match="must divide"):
        exb_mod.exb(inp, block_iv=3, block_iz=1)
    bad = dict(inp, vl=inp["vl"][:2])
    with pytest.raises(ValueError, match="vl"):
        exb_mod.exb(bad, block_iv=1, block_iz=1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        exb_mod.exb_cuda(inp, block_iv=1, block_iz=1)
    q, k, v = carry.attention_inputs(*qkv_numpy(seed=4, S=32, H=3, KV=2), device="cpu")
    with pytest.raises(ValueError, match="query heads"):
        fa_mod.flash_attention(q, k, v)
    q, k, v = carry.attention_inputs(*qkv_numpy(seed=4, S=32), device="cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa_mod.flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match=">= 1"):
        fa_mod.flash_attention(q, k, v, block_q=0)


def test_launch_errors_raise():
    _build.check(0, "ok")
    with pytest.raises(RuntimeError, match="error 9"):
        _build.check(9, "flash_attention_launch")


@pytest.mark.parametrize("space", ["exb", "flash_S256", "flash_S200"])
def test_every_emitted_point_passes_the_wrapper_checks(space):
    """The emitted space is exactly what the wrapper takes: every point
    passes its tile checks and, for flash, fits the shared memory the
    kernel is launched with (``chip_smoke.py`` launches each on the card)."""
    if space == "exb":
        region = exb_ops.exb_region(dims=EXB_DIMS)
        inp = carry.exb_inputs(exb_numpy(seed=8), device="cpu")
        assert region.space.size() == 9  # a 144-float plane: one piece
        for point in region.space.points():
            exb_mod._check_inputs(inp, point["block_iv"], point["block_iz"], point["split"])
        return
    S = int(space.split("S")[1])
    q, k, v = carry.attention_inputs(*qkv_numpy(seed=9, S=S), device="cpu")
    region = fa_ops.flash_region(S, 16)
    assert {p["block_q"] for p in region.space.points()} == set(fa_mod.F32_BLOCK_Q)
    for point in region.space.points():
        bq, bkv = point["block_q"], point["block_kv"]
        fa_mod._check(q, k, v, bq, bkv)
        assert (16, bq, bkv) in fa_mod.F32_TILES
        assert fa_mod.smem_bytes(bq, bkv, 16, 4) <= region.arch.smem_per_block


def test_precompile_warms_every_candidate_once():
    inp = carry.exb_inputs(exb_numpy(seed=12), device="cpu")
    region = exb_ops.exb_region(dims=EXB_DIMS)
    exb_mod.counter.reset()
    assert region.precompile((inp,)) == region.space.size()
    assert exb_mod.counter.plain_calls == region.space.size()
    assert all(region.is_compiled(p) for p in region.space.points())
    assert region.precompile((inp,)) == 0  # already warm: nothing runs


def test_carry_keeps_layout_and_values():
    q, k, v = qkv_numpy(seed=6, S=8, H=4, KV=2)
    tq, tk, tv = carry.attention_inputs(q, k, v, device="cpu")
    assert tuple(tq.shape) == (1, 8, 4, 16) and tuple(tk.shape) == (1, 8, 2, 16)
    np.testing.assert_array_equal(carry.to_numpy(tv), v)
    bf = carry.attention_inputs(q, k, v, device="cpu", dtype=torch.bfloat16)[0]
    assert bf.dtype == torch.bfloat16 and bf.is_contiguous()
    jax_bf = np.asarray(jnp.asarray(q).astype(jnp.bfloat16))
    np.testing.assert_array_equal(carry.to_numpy(carry.to_tensor(jax_bf, "cpu")),
                                  carry.to_numpy(bf))
