"""The port's encoder-decoder (whisper) against the JAX package's, on the
SMOKE config: ``forward`` logits, ``prefill_fn`` last logits and every
cache leaf, and 8 greedy ``decode_fn`` steps, with the JAX ``init_params``
weights carried across, once in float32 (tokens equal, rows within 1e-3 of
their largest logit) and once in bf16 (worst row within 4·2⁻⁸). Tolerances
and the runs: ``test_torch_models_parity``. With float32 weights the encoder's
layers keep their bf16 weights on both sides (the JAX encoder's scan takes
only a bf16 carry). On the CPU, the decoder's causal attention takes the
flash kernel's plain version."""
from __future__ import annotations

import pytest

import test_torch_models_parity as P

ARCHS = ["whisper-large-v3"]
MODES = ["f32", "bf16"]


@pytest.fixture(scope="module")
def runs():
    return P.Runs()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch, mode, runs):
    P.check_forward(arch, mode, *runs(arch, mode))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(arch, mode, runs):
    P.check_prefill(arch, mode, *runs(arch, mode))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_jax(arch, mode, runs):
    P.check_decode(arch, mode, *runs(arch, mode))
