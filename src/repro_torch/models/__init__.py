"""Model zoo: the 10 LM-family architectures of ``repro.models`` in PyTorch.

Serving entry points (forward, prefill, decode) for every family, on the
port's hand-written kernels where the path has one: causal self-attention
on ``flash_attention``, the Mamba recurrence on ``ssm_scan``, the RG-LRU
recurrence on ``rglru_scan``, each through ``autotuned(name)`` on CUDA
tensors, their plain versions on CPU tensors (:mod:`.route`); inside
:func:`serving` a kernel call resolves by the serving rule, never tuning
on the serving thread unless asked.
"""
from .config import ModelConfig
from .model import (
    analytic_param_count,
    analytic_step_flops,
    cache_batch_axis,
    decode_fn,
    forward,
    init_cache,
    init_params,
    input_logical_axes,
    input_specs,
    make_concrete_batch,
    param_specs,
    prefill_fn,
    train_loss,
)
from .route import ServingRule, plain_versions, serving
from .spec import ParamSpec, Params, count_params

__all__ = [
    "ModelConfig",
    "ParamSpec",
    "Params",
    "param_specs",
    "init_params",
    "forward",
    "train_loss",
    "prefill_fn",
    "decode_fn",
    "init_cache",
    "make_concrete_batch",
    "analytic_param_count",
    "analytic_step_flops",
    "count_params",
    "plain_versions",
    "serving",
    "ServingRule",
    "cache_batch_axis",
    "input_specs",
    "input_logical_axes",
]
