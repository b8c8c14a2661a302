"""The two recurrent families at their published widths against the JAX
package on the CPU, as ``test_torch_models_fullwidth`` holds the other
families: falcon-mamba-7b's FULL config (d_model 4096, d_inner 8192, 16
states) cut to 2 layers, and recurrentgemma-2b's (d_model and RG-LRU width
2560, 10|1 heads at head dim 256) cut to 3 layers, one (rec, rec, attn)
group, its d_ff to 1024 as qwen2.5-32b's; both with a 512-token
vocabulary.  Each runs ``forward``, ``prefill_fn`` and 4 greedy
``decode_fn`` steps on the JAX ``init_params`` weights, wq and wk tempered
(the parity helper's "-tempered" modes; falcon-mamba-7b has neither, so its
weights are the JAX init's), in float32 and in bf16.  The prompt, 32
tokens, stays inside recurrentgemma-2b's 2048-position window: past it both
packages share the decode ring fault of ``ROADMAP.md`` §C, which the SMOKE
parity tests pin.

Tolerances: float32 at the parity helper's (``test_torch_models_parity``).
bf16 array by array against exact arithmetic, where exact is the port's
float32 run on the same (bf16-valued) weights fed the same tokens, which
the float32 tests hold to the JAX package's within 1e-3: where the JAX
package's own bf16 array lies within 4·2⁻⁸ (worst row ``‖jax − exact‖ /
‖exact‖``) of exact, the port's lies within 4·2⁻⁸ of the JAX package's, the
parity helper's bf16 rule; where it lies farther, the port's own distance
from exact is at most ``BF16_OWN_RATIO`` (1.25) times the JAX package's,
so a port that kept its state in lower precision than the JAX package
fails.  At these widths Δ, B_t and C_t (falcon) and the RG-LRU gates come
out of bf16 products of 8192 and 2560 terms, and one bf16 ulp of them
moves a layer's output by ~0.5%: the JAX package's bf16 forward lies 3.1%
(falcon) and 2.6% (recurrentgemma) from exact, and falcon's bf16 prefill
state ``h`` 39.7% (``ROADMAP.md`` §C).
Decode after prefill is held in both packages at the JAX package's own
rule, and in float32 the port's gap to the JAX package's.
Alone this file takes ~150 s on a CPU host (the JAX side op by op)."""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_models_parity as P
from repro_torch import carry
from repro_torch import models as tm
from repro_torch.configs import get_config

CUTS = {
    "falcon-mamba-7b": (("n_layers", 2), ("vocab_size", 512)),
    "recurrentgemma-2b": (("n_layers", 3), ("vocab_size", 512), ("d_ff", 1024)),
}
SEQ = 32
STEPS = 4
MODES = ["f32-tempered", "bf16-tempered"]
ARCHS = list(CUTS)
# the port's bf16 distance from exact arithmetic, at most this many times
# the JAX package's, where that exceeds 4·2⁻⁸
BF16_OWN_RATIO = 1.25


@pytest.fixture(scope="module")
def runs():
    made = P.Runs()
    return lambda arch, mode: made(arch, mode, CUTS[arch], SEQ, STEPS)


@pytest.fixture(scope="module")
def exact(runs):
    """The port's float32 run on the bf16 case's weights cast to float32,
    fed the bf16 JAX run's inputs and greedy tokens."""

    @functools.lru_cache(maxsize=None)
    def run(arch: str):
        ref = runs(arch, "bf16-tempered")[0]
        as_f32 = dict(ref, params=jax.tree.map(lambda a: np.asarray(a, np.float32),
                                               ref["params"]))
        return P.run_port(arch, "f32-tempered", as_f32, CUTS[arch])

    return run


def hold_bf16(got, ref, truth, what: str) -> None:
    """The port's bf16 array against the JAX package's: within 4·2⁻⁸ of it
    where the JAX array lies within 4·2⁻⁸ of exact arithmetic, else no
    farther from exact than ``BF16_OWN_RATIO`` times the JAX array."""
    _, apart = P.row_errors(got, ref)
    _, own = P.row_errors(ref, truth)
    _, ours = P.row_errors(got, truth)
    print(f"{what}: port vs JAX {apart:.4g}; from exact: JAX {own:.4g}, port {ours:.4g}")
    if own <= P.BF16_ROW:
        assert apart <= P.BF16_ROW, f"{what}: worst row {apart} > {P.BF16_ROW}"
    else:
        assert ours <= BF16_OWN_RATIO * own, (
            f"{what}: the port's bf16 error {ours} > {BF16_OWN_RATIO} x JAX's {own}")


def hold_cache(got, ref, truth, what: str) -> None:
    assert set(got) == set(ref), (sorted(got), sorted(ref))
    for key, r in ref.items():
        if key == "len":
            assert int(got[key]) == int(r), f"{what} len {got[key]} != {r}"
        else:
            hold_bf16(got[key], r, truth[key], f"{what} cache {key}")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch, mode, runs, exact):
    ref, port = runs(arch, mode)
    if mode.startswith("f32"):
        P.check_forward(arch, mode, ref, port)
    else:
        hold_bf16(port["forward"], ref["forward"], exact(arch)["forward"], f"{arch} forward")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(arch, mode, runs, exact):
    ref, port = runs(arch, mode)
    if mode.startswith("f32"):
        P.check_prefill(arch, mode, ref, port)
        return
    truth = exact(arch)
    hold_bf16(port["prefill"], ref["prefill"], truth["prefill"], f"{arch} prefill")
    hold_cache(port["cache"], ref["cache"], truth["cache"], f"{arch} prefill")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_jax(arch, mode, runs, exact):
    ref, port = runs(arch, mode)
    if mode.startswith("f32"):
        P.check_decode(arch, mode, ref, port)
        return
    truth = exact(arch)
    for i, (got, want, x) in enumerate(zip(port["steps"], ref["steps"], truth["steps"])):
        hold_bf16(got, want, x, f"{arch} decode step {i}")
    hold_cache(port["final_cache"], ref["final_cache"], truth["final_cache"], f"{arch} decode")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_after_prefill_as_jax(arch, mode, runs):
    """Decode after prefill in both packages on the same weights: the
    prompt's prefill and one decode step of its first greedy token against
    prefill of the prompt and that token.  Both within the rule the JAX
    package holds its own SMOKE models to (``tests/test_models.py``: rtol
    0.1, atol 0.08); in float32 the port's gap at most ``BF16_OWN_RATIO``
    times the JAX package's.  The gap is not zero in float32: both packages
    keep the conv caches in bf16 (falcon-mamba-7b 8.6e-3 in each,
    recurrentgemma-2b 7.6e-3), and the bf16 gaps are the two packages'
    rounding (falcon-mamba-7b 0.031 in each)."""
    ref, port = runs(arch, mode)
    jcfg, cfg = P.configs(arch, CUTS[arch])
    tokens = np.concatenate([ref["batch"]["tokens"], ref["tokens"][0]], axis=1)
    with jax.disable_jit():
        whole, _ = P.jax_prefill(jax.tree.map(jnp.asarray, ref["params"]),
                                 {"tokens": jnp.asarray(tokens)}, jcfg)
    params = carry.model_params(cfg, ref["params"], device="cpu")
    ours, _ = tm.prefill_fn(params, {"tokens": torch.from_numpy(tokens).long()}, cfg)
    gaps = {}
    for who, step, full in (("JAX", ref["steps"][0], whole),
                            ("port", port["steps"][0], ours.float().numpy())):
        step, full = np.asarray(step, np.float64), np.asarray(full, np.float64)
        gaps[who] = np.abs(step - full)
        assert (gaps[who] <= 0.08 + 0.1 * np.abs(full)).all(), (
            f"{arch} {mode}: {who}'s decode after prefill off by {gaps[who].max()}")
    print(f"{arch} {mode}: decode after prefill, max abs gap port {gaps['port'].max():.4g}, "
          f"JAX {gaps['JAX'].max():.4g}")
    if mode.startswith("f32"):
        assert gaps["port"].max() <= BF16_OWN_RATIO * gaps["JAX"].max()


@pytest.mark.parametrize("arch", ARCHS)
def test_exact_run_matches_jax_float32(arch, runs, exact):
    """The yardstick of the bf16 tests: the port's float32 run on the bf16
    weights is the JAX package's float32 run (the f32 mode's weights are
    the same bf16 values cast), to the float32 rule."""
    ref, _ = runs(arch, "f32-tempered")
    P.check_forward(arch, "f32", ref, exact(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_full_configs_keep_their_widths(arch):
    """The cut changes depth, vocabulary (and recurrentgemma-2b's d_ff)
    only, in both packages alike; the prompt stays inside the window."""
    jcfg, cfg = P.configs(arch, CUTS[arch])
    for field in ("family", "d_model", "n_heads", "n_kv_heads", "head_dim_", "ssm_state",
                  "d_conv", "expand", "d_inner", "lru_width_", "block_pattern",
                  "local_window"):
        assert getattr(cfg, field) == getattr(get_config(arch), field), (arch, field)
        assert getattr(cfg, field) == getattr(jcfg, field), (arch, field)
    assert SEQ + STEPS < cfg.local_window
