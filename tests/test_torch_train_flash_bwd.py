"""The flash backward's plain version and autograd route against the JAX
package: ``attention_bwd_plain`` against ``jax.vjp`` of
``flash_attention_xla`` (whose backward is ``_flash_bwd``) on the residuals
JAX's own forward saves, and against ``jax.vjp`` of ``full_attention``;
the forward's ``lse`` against ``_flash_forward_blocks``; the port's
``FlashAttentionFn`` with both kernels swapped for their plain versions
through ``torch.autograd.gradcheck`` in float64; and the
``flash_attention_bwd`` registry op on CPU tensors.

Tolerances: float32 ``DEFAULT_TOL`` per element; bf16 ``DEFAULT_TOL``
per element and the worst row's ``‖port − jax‖ / ‖jax‖`` within 4·2⁻⁸
(four bf16 ulps): both sides round S, dP, P and dS to bf16 where the JAX
function does, but JAX rounds each block's product to bf16 before its
float32 sum, the plain version the whole sum once.  The JAX side runs op by
op in bf16 (``jax.disable_jit``), as ``test_torch_models_parity`` does."""
from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformance import DEFAULT_TOL
from repro.models.attention import _flash_forward_blocks, flash_attention_xla, full_attention
from repro_torch.configs import get_config
from repro_torch.core import autotuned
from repro_torch.kernels.flash_attention import flash_attention as fa_mod
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_bwd_plain, attention_ref
from repro_torch.models.attention import FlashAttentionFn, causal_attention
from repro_torch.models.transformer import maybe_checkpoint

BF16_ROW = 4 * 2.0 ** -8
# (S, (H, KV), hd, block): every S, head layout and head dim at least once
CASES = [(64, (4, 2), 16, 32), (200, (8, 1), 64, 100), (200, (4, 2), 36, 100),
         (64, (8, 1), 36, 32)]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, S, H, KV, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((1, S, H, hd), (1, S, KV, hd), (1, S, KV, hd), (1, S, H, hd))]


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _close(port, ref, dtype: str, label: str) -> None:
    port = port.float().numpy()
    ref = np.asarray(ref, np.float32)
    rtol, atol = DEFAULT_TOL[dtype]
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol, err_msg=label)
    if dtype == "bfloat16":
        rows = np.linalg.norm(port - ref, axis=-1) / np.maximum(
            np.linalg.norm(ref, axis=-1), 1e-30)
        assert rows.max() <= BF16_ROW, f"{label}: worst row {rows.max()}"


def _jax_mode(dtype: str):
    return jax.disable_jit() if dtype == "bfloat16" else contextlib.nullcontext()


# bf16 runs op by op (~6 s a case): three cases take every S, layout and hd
FLASH_VJP_CASES = ([(*c, "float32") for c in CASES]
                   + [(*c, "bfloat16") for c in CASES[:3]])


@pytest.mark.parametrize("S,heads,hd,block,dtype", FLASH_VJP_CASES)
def test_bwd_plain_matches_jax_flash_vjp(S, heads, hd, block, dtype):
    H, KV = heads
    jdt, tdt = DTYPES[dtype]
    q, k, v, do = (jnp.asarray(a, jdt) for a in _inputs(S + hd, S, H, KV, hd))
    with _jax_mode(dtype):
        o, lse = _flash_forward_blocks(q, k, v, block, block)
        _, vjp = jax.vjp(lambda a, b, c: flash_attention_xla(a, b, c, block, block), q, k, v)
        want = vjp(do)
    tq, tk, tv, to, tdo = (_t(a, tdt) for a in (q, k, v, o, do))
    tlse = _t(lse, torch.float32).reshape(1, H, S)
    got = attention_bwd_plain(tq, tk, tv, to, tlse, tdo)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == tdt
        _close(g, w, dtype, f"{name} S={S} {H}|{KV} hd={hd} {dtype}")


@pytest.mark.parametrize("S,heads,hd,block", CASES)
def test_bwd_plain_matches_jax_grad_of_full_attention(S, heads, hd, block):
    H, KV = heads
    q, k, v, do = (jnp.asarray(a) for a in _inputs(S + 2 * hd, S, H, KV, hd))
    _, vjp = jax.vjp(lambda a, b, c: full_attention(a, b, c, causal=True), q, k, v)
    want = vjp(do)
    tq, tk, tv, tdo = (_t(a, torch.float32) for a in (q, k, v, do))
    o, lse = attention_ref(tq, tk, tv, return_lse=True)
    got = attention_bwd_plain(tq, tk, tv, o, lse, tdo)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g, w, "float32", f"{name} S={S} {H}|{KV} hd={hd}")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("S,heads,hd,block", CASES[:2])
def test_forward_lse_matches_jax(S, heads, hd, block, dtype):
    H, KV = heads
    jdt, tdt = DTYPES[dtype]
    q, k, v, _ = (jnp.asarray(a, jdt) for a in _inputs(S, S, H, KV, hd))
    with _jax_mode(dtype):
        o_jax, lse_jax = _flash_forward_blocks(q, k, v, block, block)
    o, lse = attention_ref(*(_t(a, tdt) for a in (q, k, v)), return_lse=True)
    assert lse.shape == (1, H, S) and lse.dtype == torch.float32
    # (B, KV, G, S) flattened to (B, H, S), query head h = kv·G + g
    _close(lse, np.asarray(lse_jax, np.float32).reshape(1, H, S), dtype, "lse")
    _close(o, o_jax, dtype, "o")


def _plain_forward(q, k, v):
    return attention_ref(q, k, v, return_lse=True)


def test_flash_attention_fn_gradcheck_float64():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(s)).requires_grad_()
               for s in ((1, 7, 4, 8), (1, 7, 2, 8), (1, 7, 2, 8)))
    assert torch.autograd.gradcheck(
        lambda a, b, c: FlashAttentionFn.apply(a, b, c, _plain_forward, attention_bwd_plain),
        (q, k, v))


def test_flash_attention_fn_saves_o_and_lse_and_matches_autograd():
    """The Function's gradient equals autograd's through the plain
    forward; it saves (q, k, v, o, lse): O(S·d), no S×S score."""
    rng = np.random.default_rng(4)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   for s in ((2, 24, 4, 16), (2, 24, 2, 16), (2, 24, 2, 16), (2, 24, 4, 16)))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t.shape) or t,
                                                  lambda t: t):
        out = FlashAttentionFn.apply(*leaves, _plain_forward, attention_bwd_plain)
    got = torch.autograd.grad(out, leaves, do)
    assert sorted(saved) == sorted([(2, 24, 4, 16), (2, 24, 2, 16), (2, 24, 2, 16),
                                    (2, 24, 4, 16), (2, 4, 24)])
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(attention_ref(*ref_leaves), ref_leaves, do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_flash_attention_fn_under_remat(remat):
    """Under ``full`` and under ``dots`` (selective checkpointing: it keeps
    the 2-D matmuls' outputs and sees the Function as one op to recompute)
    the Function's forward runs again in the recompute and the o and lse it
    saves reach its backward: the gradients equal those without remat."""
    rng = np.random.default_rng(6)
    B, S, D = 2, 24, 32
    x, wq, wk, wv, wo = (torch.from_numpy(rng.standard_normal(s).astype(np.float32) / 4)
                         for s in ((B * S, D), (D, 64), (D, 32), (D, 32), (64, D)))
    calls = []

    def forward(q, k, v):
        calls.append("forward")
        return _plain_forward(q, k, v)

    def backward(*args):
        calls.append("backward")
        return attention_bwd_plain(*args)

    def layer(x, wq, wk, wv, wo):
        q, k, v = ((x @ w).reshape(B, S, -1, 16) for w in (wq, wk, wv))
        return FlashAttentionFn.apply(q, k, v, forward, backward).reshape(B * S, -1) @ wo

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (x, wq, wk, wv, wo)]
        return torch.autograd.grad(fn(*leaves).square().sum(), leaves)

    want = grads(layer)
    assert calls == ["forward", "backward"]
    calls.clear()
    got = grads(maybe_checkpoint(layer, get_config("tinyllama-1.1b", smoke=True).with_(
        remat=remat)))
    assert calls == ["forward", "forward", "backward"]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=2e-4, atol=1e-5)


def test_causal_attention_on_the_cpu_differentiates_through_the_plain_version():
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).requires_grad_()
               for s in ((1, 16, 4, 8), (1, 16, 2, 8), (1, 16, 2, 8)))
    before = fa_mod.counter.plain_calls
    out = causal_attention(q, k, v)
    out.square().sum().backward()
    assert fa_mod.counter.plain_calls == before + 1
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all()) for t in (q, k, v))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_registry_op_on_cpu_tensors(dtype):
    _, tdt = DTYPES[dtype]
    q, k, v, do = (_t(a, tdt) for a in _inputs(9, 48, 4, 2, 16))
    o, lse = attention_ref(q, k, v, return_lse=True)
    before = fa_mod.bwd_counter.plain_calls
    got = autotuned("flash_attention_bwd")(q, k, v, o, lse, do)
    assert fa_mod.bwd_counter.plain_calls > before
    for g, w in zip(got, attention_bwd_plain(q, k, v, o, lse, do)):
        assert torch.equal(g, w)
    bp = fa_ops.bwd_shape_class(q, k, v, o, lse, do)
    assert (bp["kernel"], bp["group"], bp["seq"], bp["hd"]) == ("flash_attention_bwd", 2, 48, 16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [16, 36, 64, 128, 200, 256])
def test_bwd_emitted_points_are_the_instantiated_tiles(hd, dtype):
    region = fa_ops.flash_bwd_region(4096, hd, dtype, heads=128, group=8)
    points = list(region.space.points())
    tile = fa_mod.tile_hd(fa_mod.padded_hd(hd, dtype), dtype)
    want = {(bq, bkv) for t, bq, bkv in fa_mod.BWD_TILES[dtype] if t == tile}
    assert {(p["block_q"], p["block_kv"]) for p in points} == want
    elt = 2 if dtype == "bfloat16" else 4
    for p in points:
        assert fa_mod.bwd_launchable(fa_mod.padded_hd(hd, dtype), dtype, group=8, **p)
        assert fa_mod.bwd_smem_bytes(p["block_q"], p["block_kv"], hd, elt) <= 227 * 1024


def test_bwd_smem_model_counts_the_sources_tiles():
    # mma.sync DkvTile: q, do, k, v tiles of (tile hd + pad) elements and lse, delta
    assert fa_mod.bwd_smem_bytes(64, 32, 256, 2) == 2 * 264 * 192 + 512
    assert fa_mod.bwd_smem_bytes(64, 32, 256, 4) == 4 * 260 * 192 + 512
    # bf16 below hd 256, the wgmma kernel's dk/dv pass: 1 KiB of alignment, k
    # and v, two stages of q, do, lse and delta, 64 B of barriers
    assert fa_mod.bwd_smem_bytes(64, 64, 64, 2) == 1024 + 2 * 8192 + 2 * (2 * 8192 + 512) + 64
