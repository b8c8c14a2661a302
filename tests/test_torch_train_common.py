"""Shared by the ``tests/test_torch_train_*.py`` files (this module holds
no test itself): one arch's float32 SMOKE training state in both packages,
its synthetic batches, and the JAX train step run on them.

The weights are the JAX ``init_params`` tree cast to float32 (the Whisper
encoder keeps its bf16 layers, as in ``test_torch_models_parity``),
carried across by ``repro_torch.carry.model_params``; both packages start
AdamW from zero moments.  The batches are the JAX ``SyntheticLMDataset``'s,
which the port's copy reproduces array for array.  The JAX step runs
jitted, except Whisper's, which runs op by op (``jax.disable_jit``): the
compiled bf16 encoder keeps excess precision, as
``test_torch_models_parity`` found."""
from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np

from repro.data import SyntheticLMDataset as JaxDataset
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.runtime.train import make_train_step as jax_make_train_step
from repro_torch import carry
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.tree import as_tree
from test_torch_models_parity import configs, jax_params

# one arch per family: dense, moe, ssm, hybrid, vlm, encdec
FAMILIES = ("tinyllama-1.1b", "granite-moe-1b-a400m", "falcon-mamba-7b",
            "recurrentgemma-2b", "qwen2-vl-2b", "whisper-large-v3")
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
B, S = 4, 32


def opt_cfgs():
    return JaxAdamWConfig(**OPT), AdamWConfig(**OPT)


def jax_batches(arch: str, steps: int, batch: int = B, seq: int = S, cut=None):
    """The JAX dataset's first ``steps`` batches of ``arch``'s SMOKE config
    (or its ``cut`` FULL config, ``test_torch_models_parity.configs``)."""
    ds = JaxDataset(configs(arch, cut)[0], global_batch=batch, seq_len=seq, seed=0)
    return [ds.batch(i) for i in range(steps)]


def jax_run_mode(arch: str):
    return jax.disable_jit() if arch == "whisper-large-v3" else contextlib.nullcontext()


@functools.lru_cache(maxsize=None)
def jax_steps(arch: str, steps: int, n_micro: int = 1, cut=None, seq: int = S,
              mode: str = "f32"):
    """The JAX package's ``steps`` float32 train steps of ``arch`` from its
    init (of weight mode ``mode``, ``test_torch_models_parity.jax_params``):
    [(params as numpy, metrics as floats)] after each step."""
    jcfg = configs(arch, cut)[0]
    params = jax_params(arch, mode, cut=cut)
    jopt = opt_cfgs()[0]
    state = jax_adamw_init(params, jopt)
    step = jax_make_train_step(jcfg, jopt, n_micro)
    out = []
    with jax_run_mode(arch):
        if arch != "whisper-large-v3":
            step = jax.jit(step)
        for b in jax_batches(arch, steps, seq=seq, cut=cut):
            params, state, metrics = step(params, state, {k: jnp.asarray(v) for k, v in b.items()})
            out.append((jax.device_get(params), {k: float(v) for k, v in metrics.items()}))
    return tuple(out)


def port_state(arch: str, device="cpu", cut=None, mode: str = "f32"):
    """(cfg, params tree, AdamW state) of the port on the same float32 init."""
    cfg = configs(arch, cut)[1]
    params = as_tree(carry.model_params(cfg, jax.device_get(jax_params(arch, mode, cut=cut)),
                                        device))
    return cfg, params, adamw_init(params, opt_cfgs()[1])
