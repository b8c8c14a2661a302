"""The port's recurrent models (falcon-mamba, recurrentgemma) against the JAX
package's, on the SMOKE configs: ``forward`` logits, ``prefill_fn`` last
logits and every cache leaf, and 8 greedy ``decode_fn`` steps, with the
JAX ``init_params`` weights carried across, once in float32 (tokens equal,
rows within 1e-3 of their largest logit) and once in bf16 (worst row
within 4·2⁻⁸). Tolerances and the runs: ``test_torch_models_parity``. On the
CPU, the scans and causal attention take their kernels' plain versions
(the card's route is ``chip_smoke.py``'s). recurrentgemma's prompt is past
its window, so its attention layer takes the local window and its decode
ring holds the JAX package's layout."""
from __future__ import annotations

import pytest

import test_torch_models_parity as P

ARCHS = ["falcon-mamba-7b", "recurrentgemma-2b"]
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
