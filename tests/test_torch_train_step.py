"""The port's train step against the JAX package's, one SMOKE arch of each
family in float32 over two steps (the loss, ``grad_norm`` and every
updated parameter); microbatch degrees 1 and 2 and the three remat
directives giving the same step; the AdamW state carried across
(``carry.adamw_state``); and on the CPU the SSM and hybrid families
training through the scans' plain versions.

Tolerances: the loss and ``grad_norm`` within float32 ``DEFAULT_TOL``'s
rtol of JAX's (the gradients agree to ~6e-5 of a leaf's norm at worst,
recurrentgemma's).  Every updated parameter within rtol 2e-4 and an atol
of 2·lr a step: AdamW's update m̂/(√v̂ + eps) of an element whose gradient
is float32 noise (≲ 1e-7) has a noise direction, so it may differ by up
to that much; and each leaf's update as a whole, p − p₀, within 2e-2 of
JAX's in norm (measured: 1e-2 at worst, recurrentgemma's first step), so a
leaf whose real gradients were wrong fails.  Whisper's encoder layers stay
bf16 in the JAX model (its scan carry is bf16), so its gradient is bf16
noise: JAX's own ``grad_norm`` moves 9% between its jitted and op-by-op
runs of the same step; Whisper is held to one step, the loss within 1e-4,
``grad_norm`` within 0.2 (twice that spread) and each parameter within one
bf16 ulp plus 2·lr.  Remat changes no arithmetic, so its directives agree
to float32 ``DEFAULT_TOL``; microbatching sums the gradients in another
order, as in ``tests/test_runtime.py:150``."""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from conformance import DEFAULT_TOL
from repro.optim import adamw_init as jax_adamw_init
from repro_torch import carry
from repro_torch.runtime.train import batch_tensors, make_train_step
from repro_torch.tree import flatten
from test_torch_models_parity import jax_params
from test_torch_train_common import (
    FAMILIES, jax_batches, jax_steps, opt_cfgs, port_state,
)

RTOL = DEFAULT_TOL["float32"][0]


def _assert_params(cfg, port, want, init, steps, label):
    got = carry.model_arrays(cfg, port)
    assert jax.tree.structure(got) == jax.tree.structure(want), label
    atol = 2 * opt_cfgs()[1].lr * steps
    bf16 = cfg.is_encoder_decoder
    for i, (g, w, p0) in enumerate(zip(jax.tree.leaves(got), jax.tree.leaves(want),
                                       jax.tree.leaves(init))):
        w, p0 = np.asarray(w, np.float32), np.asarray(p0, np.float32)
        np.testing.assert_allclose(g, w, rtol=2.0 ** -7 if bf16 else 2e-4, atol=atol,
                                   err_msg=f"{label} leaf {i}")
        if not bf16:
            du, dw = g - p0, w - p0
            rel = np.linalg.norm(du - dw) / max(np.linalg.norm(dw), 1e-30)
            assert rel <= 2e-2, f"{label} leaf {i}: update off by {rel} of its norm"


def check_train_step_matches_jax(arch):
    cfg, params, state = port_state(arch)
    init = jax.device_get(jax_params(arch, "f32"))
    whisper = cfg.is_encoder_decoder
    steps = 1 if whisper else 2
    step = make_train_step(cfg, opt_cfgs()[1], 1)
    for i, (batch, (want_params, want)) in enumerate(zip(jax_batches(arch, steps),
                                                         jax_steps(arch, steps))):
        params, state, metrics = step(params, state, batch_tensors(batch, "cpu"))
        rel = {"loss": 1e-4 if whisper else RTOL, "grad_norm": 0.2 if whisper else RTOL,
               "lr": RTOL}
        for key, tol in rel.items():
            assert float(metrics[key]) == pytest.approx(want[key], rel=tol), f"{key} step {i}"
        _assert_params(cfg, params, want_params, init, i + 1, f"{arch} step {i}")


@pytest.mark.parametrize("arch", [a for a in FAMILIES if a != "whisper-large-v3"])
def test_train_step_matches_jax(arch):
    check_train_step_matches_jax(arch)


def test_adamw_state_carries_across():
    arch = "tinyllama-1.1b"
    cfg, params, _ = port_state(arch)
    jstate = jax_adamw_init(jax_params(arch, "f32"), opt_cfgs()[0])
    jstate = {"m": jax.tree.map(lambda a: a + 0.5, jstate["m"]),
              "v": jax.tree.map(lambda a: a + 0.25, jstate["v"]),
              "count": jstate["count"] + 3}
    state = carry.adamw_state(cfg, jax.device_get(jstate), device="cpu")
    assert int(state["count"]) == 3 and state["count"].dtype == torch.int32
    assert len(flatten(state["m"])[0]) == len(flatten(params)[0])
    back = carry.adamw_arrays(cfg, state)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jax.device_get(jstate))):
        np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32))


def test_microbatch_degrees_agree():
    """Gradient accumulation must not change the math (the degree PP)."""
    arch = "tinyllama-1.1b"
    cfg, params, state = port_state(arch)
    batch = batch_tensors(jax_batches(arch, 1)[0], "cpu")
    p1, _, m1 = make_train_step(cfg, opt_cfgs()[1], 1)(params, state, batch)
    p2, _, m2 = make_train_step(cfg, opt_cfgs()[1], 2)(params, state, batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-5)
    assert float(m1["grad_norm"]) == pytest.approx(float(m2["grad_norm"]), rel=1e-4)
    for a, b in zip(flatten(p1)[0], flatten(p2)[0]):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-6)


def test_microbatches_split_mrope_positions_on_their_batch_axis():
    arch = "qwen2-vl-2b"
    cfg, params, state = port_state(arch)
    batch = batch_tensors(jax_batches(arch, 1)[0], "cpu")
    assert batch["positions"].shape == (3, 4, 32)
    _, _, m1 = make_train_step(cfg, opt_cfgs()[1], 1)(params, state, batch)
    _, _, m2 = make_train_step(cfg, opt_cfgs()[1], 2)(params, state, batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-5)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "recurrentgemma-2b", "whisper-large-v3"])
def test_remat_directives_give_the_same_step(arch):
    cfg, params, state = port_state(arch)
    batch = batch_tensors(jax_batches(arch, 1)[0], "cpu")
    runs = {r: make_train_step(cfg.with_(remat=r), opt_cfgs()[1], 1)(params, state, batch)
            for r in ("none", "full", "dots")}
    rtol, atol = DEFAULT_TOL["float32"]
    for r in ("full", "dots"):
        assert float(runs[r][2]["grad_norm"]) == pytest.approx(
            float(runs["none"][2]["grad_norm"]), rel=rtol)
        for a, b in zip(flatten(runs[r][0])[0], flatten(runs["none"][0])[0]):
            torch.testing.assert_close(a, b, rtol=rtol, atol=atol)
    if not cfg.is_encoder_decoder:  # Whisper remats whole for any value but "none", as JAX
        with pytest.raises(ValueError, match="unknown remat"):
            make_train_step(cfg.with_(remat="offload"), opt_cfgs()[1], 1)(params, state, batch)


def test_the_step_leaves_its_arguments_as_they_were():
    cfg, params, state = port_state("tinyllama-1.1b")
    before = [t.clone() for t in flatten((params, state))[0]]
    make_train_step(cfg, opt_cfgs()[1], 2)(
        params, state, batch_tensors(jax_batches("tinyllama-1.1b", 1)[0], "cpu"))
    assert all(torch.equal(a, b) for a, b in zip(flatten((params, state))[0], before))
