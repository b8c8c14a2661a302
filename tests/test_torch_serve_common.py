"""Shared by the ``tests/test_torch_serve_*.py`` files (this module holds no
test itself): one arch's float32 SMOKE weights in both packages, and the
JAX serving stack run on them; and the fixture that takes what a test
registered out of the port's kernel registry again.

The weights are the JAX ``init_params`` tree cast to float32 (the Whisper
encoder keeps its bf16 layers, as in ``test_torch_models_parity``),
carried across by ``repro_torch.carry.model_params``.  The JAX side runs
compiled, as its ``Server`` and ``StreamingEngine`` do, except Whisper's:
compiled, XLA keeps excess precision across the bf16 encoder's fused
operations, and the port matches the JAX model op by op
(``jax.disable_jit``), as ``test_torch_models_parity`` found.
"""
from __future__ import annotations

import contextlib
import functools

import jax
import numpy as np
import pytest

from repro_torch import carry
from repro_torch.configs import get_config
from test_torch_models_parity import jax_params

# one arch per family: dense, moe, ssm, hybrid, vlm, encdec
FAMILIES = ("tinyllama-1.1b", "granite-moe-1b-a400m", "falcon-mamba-7b",
            "recurrentgemma-2b", "qwen2-vl-2b", "whisper-large-v3")


def jax_run_mode(arch: str):
    """The context the JAX side runs in: op by op for Whisper, else jit."""
    return jax.disable_jit() if arch == "whisper-large-v3" else contextlib.nullcontext()


@functools.lru_cache(maxsize=None)
def f32_weights(arch: str):
    """(JAX float32 params, the port's params on the CPU) of ``arch``'s
    SMOKE config, drawn once per process."""
    jp = jax_params(arch, "f32")
    cfg = get_config(arch, smoke=True)
    return jp, carry.model_params(cfg, jax.device_get(jp), device="cpu")


def same_requests(a, b) -> bool:
    """Two request lists field for field (prompts byte for byte)."""
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if (x.rid, x.max_new_tokens, x.arrival_s, x.deadline_s, x.priority) != (
                y.rid, y.max_new_tokens, y.arrival_s, y.deadline_s, y.priority):
            return False
        if x.prompt.dtype != y.prompt.dtype or not np.array_equal(x.prompt, y.prompt):
            return False
    return True


@pytest.fixture(autouse=True)
def restore_port_registry():
    """Every kernel a test registers in the port's registry (a server's
    serve ops, a fake kernel) leaves it when the test ends, so a later test
    file on the same worker sees the package's own kernels only.  Imported
    by each serve test module, where it is autouse."""
    from repro_torch.core import REGISTRY

    with REGISTRY._lock:
        specs, ops = dict(REGISTRY._specs), dict(REGISTRY._ops)
    yield
    with REGISTRY._lock:
        REGISTRY._specs.clear()
        REGISTRY._specs.update(specs)
        REGISTRY._ops.clear()
        REGISTRY._ops.update(ops)
