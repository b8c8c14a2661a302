"""The model zoo's parts against the JAX package's, on the CPU: RoPE and
M-RoPE, the norms, the MoE dispatch (against the dense oracle and the
JAX block), ``analytic_param_count`` against the specs at FULL width,
the scan's final state against the JAX ``_ssm_block_with_state``, the
weight carry's round trip, the decode cache's layout, the kernel route by
device, and the rule that prefill then one decode step equals prefill of
one more token (``tests/test_models.py``'s, for the port)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_models_parity as P
from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_config
from repro.models import analytic_param_count as jax_param_count
from repro.models import analytic_step_flops as jax_step_flops
from repro.models import init_cache as jax_init_cache
from repro.models import layers as JL
from repro.models import moe as JM
from repro.models import train_loss as jax_train_loss
from repro.models import transformer as JT
from repro_torch import carry
from repro_torch import models as tm
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels.flash_attention import flash_attention as fa_mod
from repro_torch.kernels.rglru_scan import rglru_scan as rg_mod
from repro_torch.kernels.ssm_scan import ssm_scan as ssm_mod
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.models import ssm as TS

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a: np.ndarray, dtype: str):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.tensor(a).to(tdt)


def _same(got: torch.Tensor, ref, dtype: str, what: str) -> None:
    """float32: rows within 1e-3 of their largest element; bf16: the worst
    row within 4·2⁻⁸ (``test_torch_models_parity``'s rules)."""
    P.assert_rows(got.float().numpy(), np.asarray(ref, np.float32),
                  "f32" if dtype == "float32" else "bf16", what)


def test_the_configs_are_the_jax_packages():
    assert ARCH_IDS == JAX_ARCH_IDS
    for arch in ARCH_IDS:
        for smoke in (False, True):
            ours, theirs = get_config(arch, smoke), jax_config(arch, smoke)
            assert ours.__dict__ == theirs.__dict__, arch


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_and_mrope_match_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 500, (2, 12)).astype(np.int32)
    mpos = rng.integers(0, 500, (3, 2, 12)).astype(np.int32)
    jx, tx = _pair(x, dtype)
    _same(TL.rope_apply(tx, torch.tensor(pos), 10000.0),
          JL.rope_apply(jx, jnp.asarray(pos), 10000.0), dtype, "rope")
    _same(TL.mrope_apply(tx, torch.tensor(mpos), 1e6, (4, 6, 6)),
          JL.mrope_apply(jx, jnp.asarray(mpos), 1e6, (4, 6, 6)), dtype, "mrope")
    # the half-split rotation: text tokens (three equal ids) are plain RoPE
    same = np.broadcast_to(pos, (3, 2, 12))
    torch.testing.assert_close(TL.mrope_apply(tx, torch.tensor(same), 1e6, (4, 6, 6)),
                               TL.rope_apply(tx, torch.tensor(pos), 1e6))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_jax(dtype):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((3, 5, 64)) * 3 + 1).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    (jx, tx), (jw, tw), (jb, tb) = _pair(x, dtype), _pair(w, dtype), _pair(b, dtype)
    got = TL.rmsnorm(tx, tw, 1e-6)
    assert got.dtype == tx.dtype
    _same(got, JL.rmsnorm(jx, jw, 1e-6), dtype, "rmsnorm")
    got = TL.layernorm(tx, {"scale": tw, "bias": tb}, 1e-6)
    assert got.dtype == tx.dtype
    _same(got, JL.layernorm(jx, {"scale": jw, "bias": jb}, 1e-6), dtype, "layernorm")


def _moe_case(arch: str, capacity_factor: float):
    cfg = get_config(arch, smoke=True).with_(capacity_factor=capacity_factor)
    jcfg = jax_config(arch, smoke=True).with_(capacity_factor=capacity_factor)
    spec = tm.param_specs(cfg)["layers"][0]["moe"]
    p = tm.spec.init_params(spec, torch.Generator().manual_seed(3), "cpu")
    p32 = {k: v.float() for k, v in p.items()}
    x = torch.randn((2, 8, cfg.d_model), generator=torch.Generator().manual_seed(4))
    return cfg, jcfg, p32, x


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "llama4-scout-17b-a16e"])
def test_moe_dispatch_matches_the_dense_oracle_without_drops(arch):
    cfg, _, p, x = _moe_case(arch, capacity_factor=8.0)  # no expert overflows
    out, aux = TM.moe_block(x, p, cfg)
    torch.testing.assert_close(out, TM.moe_block_dense_oracle(x, p, cfg), rtol=1e-5, atol=1e-5)
    assert aux.shape == () and float(aux) > 0


@pytest.mark.parametrize("capacity_factor", [8.0, 0.5])
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "llama4-scout-17b-a16e"])
def test_moe_block_matches_jax(arch, capacity_factor):
    """Capacity 0.5 drops tokens: the same ones on both sides."""
    cfg, jcfg, p, x = _moe_case(arch, capacity_factor)
    jp = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
    jout, jaux = JM.moe_block(jnp.asarray(x.numpy()), jp, jcfg)
    out, aux = TM.moe_block(x, p, cfg)
    _same(out, jout, "float32", f"moe {arch}")
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    assert TM.capacity(16, cfg) == JM.capacity(16, jcfg)


def test_top_k_breaks_ties_to_the_lower_index_as_jax():
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.5, 3.0], [2.0, 2.0, 2.0, 2.0, 2.0]])
    vals, idx = TM.top_k(logits, 3)
    jv, ji = jax.lax.top_k(jnp.asarray(logits.numpy()), 3)
    assert idx.tolist() == np.asarray(ji).tolist() == [[1, 2, 4], [0, 1, 2]]
    assert vals.tolist() == np.asarray(jv).tolist()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_param_count_matches_the_specs_at_full_width(arch):
    """Exact for every family but the encoder-decoder, whose JAX formula
    counts one d_model too many per layer (an MLP bias); within the JAX
    package's own 2% there (``tests/test_models.py``)."""
    cfg = get_config(arch)
    specs = tm.count_params(tm.param_specs(cfg))
    analytic = tm.analytic_param_count(cfg)
    if cfg.is_encoder_decoder:
        assert analytic - specs == cfg.d_model * (cfg.n_layers + cfg.n_encoder_layers)
        assert abs(analytic - specs) / specs < 0.02
    else:
        assert analytic == specs
    jcfg = jax_config(arch)
    assert analytic == jax_param_count(jcfg)
    for kind in ("train", "prefill", "decode"):
        assert tm.analytic_step_flops(cfg, kind, 2, 4096) == jax_step_flops(jcfg, kind, 2, 4096)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_ssm_scan_final_state_matches_the_jax_block(dtype):
    """The state the plain scan returns is the JAX ``_ssm_block_with_state``'s
    ``h_final``, and the block's output and conv window match too."""
    cfg = get_config("falcon-mamba-7b", smoke=True)
    jcfg = jax_config("falcon-mamba-7b", smoke=True)
    arrays = P.jax_params("falcon-mamba-7b", "f32" if dtype == "float32" else "bf16")
    jp = jax.tree.map(lambda a: a[0], arrays["layers"]["ssm"])
    tp = carry.model_params(cfg, jax.tree.map(np.asarray, arrays), device="cpu")
    x = np.random.default_rng(5).standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    with jax.disable_jit():
        jout, jfinal = JT._ssm_block_with_state(jx, jp, jcfg)
    out, final = TS.ssm_block_with_state(tx, tp["layers"][0]["ssm"], cfg)
    assert final["h"].dtype == torch.float32 and final["conv"].dtype == torch.bfloat16
    mode = "f32" if dtype == "float32" else "bf16"
    P.assert_rows(final["h"].numpy(), np.asarray(jfinal["h"]), mode, "h_final")
    P.assert_rows(final["conv"].float().numpy(), np.asarray(jfinal["conv"], np.float32), mode,
                  "conv window", bf16_leaf=True)
    P.assert_rows(out.float().numpy(), np.asarray(jout, np.float32), mode, "block output")


def test_the_scan_wrappers_final_state_on_the_cpu():
    """``ssm_scan(..., final_state=True)`` on CPU tensors returns the plain
    version's (y, h): h is the state after the last step, which one more
    step from it continues."""
    g = torch.Generator().manual_seed(6)
    x, dt, A, Bc, Cc, D = (torch.randn(s, generator=g) for s in
                           ((2, 9, 32), (2, 9, 32), (32, 4), (2, 9, 4), (2, 9, 4), (32,)))
    dt, A = dt.abs() * 0.1, -A.abs()
    y, h = ssm_mod.ssm_scan(x, dt, A, Bc, Cc, D, final_state=True)
    assert tuple(h.shape) == (2, 32, 4) and h.dtype == torch.float32
    torch.testing.assert_close(y, ssm_mod.ssm_scan(x, dt, A, Bc, Cc, D))
    y8, h8 = ssm_mod.ssm_scan_plain(x[:, :8], dt[:, :8], A, Bc[:, :8], Cc[:, :8], D,
                                    final_state=True)
    step = torch.exp(dt[:, 8, :, None] * A) * h8 + (dt[:, 8] * x[:, 8])[..., None] * Bc[:, 8, None, :]
    torch.testing.assert_close(h, step)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_carry_round_trip_keeps_every_leaf(arch):
    """JAX tree -> the port's parameters -> the JAX tree: every leaf equal,
    bf16 kept bf16; and with ``dtype`` every leaf cast."""
    arrays = jax.tree.map(np.asarray, P.jax_params(arch, "bf16"))
    cfg = get_config(arch, smoke=True)
    params = carry.model_params(cfg, arrays, device="cpu")
    assert all(t.dtype == torch.bfloat16 for t in params.parameters())
    assert sum(t.numel() for t in params.parameters()) == tm.count_params(tm.param_specs(cfg))
    back = carry.model_arrays(cfg, params)
    leaves, tree = jax.tree.flatten(arrays)
    back_leaves, back_tree = jax.tree.flatten(back)
    assert tree == back_tree
    for a, b in zip(leaves, back_leaves):
        assert np.array_equal(np.asarray(a, np.float32), b)
    f32 = carry.model_params(cfg, arrays, device="cpu", dtype=torch.float32)
    assert all(t.dtype == torch.float32 for t in f32.parameters())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_cache_has_the_jax_layout(arch):
    cfg, jcfg = get_config(arch, smoke=True), jax_config(arch, smoke=True)
    ours = tm.init_cache(cfg, 2, 20, device="cpu")
    theirs = jax_init_cache(jcfg, 2, 20)
    assert set(ours) == set(theirs)
    for key, ref in theirs.items():
        if key == "len":
            assert ours[key] == 0
            continue
        assert tuple(ours[key].shape) == ref.shape, key
        assert str(ours[key].dtype).replace("torch.", "") == str(ref.dtype), key


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "granite-moe-1b-a400m", "qwen2-vl-2b"])
def test_train_loss_matches_jax(arch):
    """The loss value (CE + MoE aux) with float32 weights, masked as the
    JAX ``make_concrete_batch`` masks a VLM's vision tokens."""
    cfg, jcfg = get_config(arch, smoke=True), jax_config(arch, smoke=True)
    arrays = P.jax_params(arch, "f32")
    params = carry.model_params(cfg, jax.tree.map(np.asarray, arrays), device="cpu")
    batch = P.inputs(cfg, 7)
    rng = np.random.default_rng(8)
    batch["targets"] = rng.integers(0, cfg.vocab_size, batch["tokens"].shape).astype(np.int32)
    mask = np.ones(batch["tokens"].shape, np.float32)
    if cfg.family == "vlm":
        mask[:, :cfg.n_vision_tokens] = 0.0
    batch["loss_mask"] = mask
    with jax.disable_jit():
        ref = float(jax_train_loss(arrays, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg))
    tb = {k: torch.tensor(v).long() if v.dtype == np.int32 else torch.tensor(v)
          for k, v in batch.items()}
    np.testing.assert_allclose(float(tm.train_loss(params, tb, cfg)), ref, rtol=1e-5)


def test_init_params_draws_from_the_generator_by_the_jax_rules():
    cfg = get_config("recurrentgemma-2b", smoke=True)
    a = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    b = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    c = tm.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    assert not torch.equal(a["embed"], c["embed"])
    rec, attn = a["layers"][0], a["layers"][2]
    assert "rec" in rec and "attn" in attn and len(a["layers"]) == cfg.n_layers
    assert torch.all(rec["ln1"] == 1) and torch.all(rec["rec"]["conv_b"] == 0)
    lam = torch.sigmoid(rec["rec"]["lam"].float())  # sigmoid(Λ) in [0.9, 0.999]
    assert float(lam.min()) >= 0.899 and float(lam.max()) <= 0.9995
    assert abs(float(a["embed"].float().std()) - 0.02) < 0.005  # init_scale
    fan_in = cfg.lru_width_  # wa: (w, w), fan-in scaled
    assert abs(float(rec["rec"]["wa"].float().std()) - fan_in ** -0.5) < 0.03
    assert all(t.dtype == torch.bfloat16 and not t.requires_grad for t in a.parameters())


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "whisper-large-v3", "falcon-mamba-7b"])
def test_make_concrete_batch_has_the_jax_leaves(arch, kind):
    cfg = get_config(arch, smoke=True)
    got = tm.make_concrete_batch(torch.Generator().manual_seed(0), cfg, kind, 2, 12, "cpu")
    batch = got["batch"]
    assert tuple(batch["tokens"].shape) == (2, 1 if kind == "decode" else 12)
    assert int(batch["tokens"].max()) < cfg.vocab_size - 1
    if cfg.family == "vlm":
        assert tuple(batch["vision_embeds"].shape) == (2, cfg.n_vision_tokens, cfg.d_model)
        assert tuple(batch["positions"].shape) == (3, 2, batch["tokens"].shape[1])
    if cfg.is_encoder_decoder:
        assert tuple(batch["frames"].shape) == (2, cfg.encoder_len, cfg.d_model)
    if kind == "train":
        assert set(batch) >= {"targets", "loss_mask"}
    if kind == "decode":
        assert got["cache"]["len"] == 11


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "falcon-mamba-7b", "recurrentgemma-2b",
                                  "granite-moe-1b-a400m", "whisper-large-v3", "qwen2-vl-2b",
                                  "llama4-scout-17b-a16e", "qwen3-0.6b"])
def test_decode_after_prefill_matches_prefill_of_one_more_token(arch):
    """The port's own rule, as ``tests/test_models.py`` states the JAX
    package's: prefill(t_1..t_n) then decode(t_n+1) gives prefill(t_1..t_n+1)'s
    logits, to bf16 accumulation noise (the same bound)."""
    cfg = get_config(arch, smoke=True)
    params = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    B, S = 2, 16
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size - 1, (B, S + 1), generator=g)
    extra = {}
    if cfg.is_encoder_decoder:
        extra["frames"] = torch.randn((B, cfg.encoder_len, cfg.d_model), generator=g).bfloat16()
    full, _ = tm.prefill_fn(params, {"tokens": toks, **extra}, cfg)
    # hybrid attention caches are rings of the window: no room is added
    capacity = None if cfg.family == "hybrid" else S + 1
    _, cache = tm.prefill_fn(params, {"tokens": toks[:, :S], **extra}, cfg, capacity=capacity)
    step, cache = tm.decode_fn(params, {"tokens": toks[:, S:], **extra}, cache, cfg)
    assert cache["len"] == S + 1
    np.testing.assert_allclose(step.numpy(), full.numpy(), rtol=0.1, atol=0.08)


def test_cpu_tensors_take_the_plain_versions_and_count_them():
    """On the CPU every kernel of the path runs its plain version, counted
    by the kernel's wrapper, and nothing launches; ``plain_versions`` is
    the same route by name."""
    counters = (fa_mod.counter, ssm_mod.counter, rg_mod.counter)
    for arch, expect in (("tinyllama-1.1b", (2, 0, 0)), ("falcon-mamba-7b", (0, 2, 0)),
                         ("recurrentgemma-2b", (1, 0, 4))):
        cfg = get_config(arch, smoke=True)
        params = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        toks = torch.randint(0, 100, (1, 8), generator=torch.Generator().manual_seed(1))
        for c in counters:
            c.reset()
        with tm.plain_versions():
            tm.prefill_fn(params, {"tokens": toks}, cfg)
        assert tuple(c.plain_calls for c in counters) == expect, arch
        assert all(c.launches == 0 for c in counters)
