"""Which version of a kernel a model's call takes.

The model zoo reaches three of the port's hand-written kernels: causal
self-attention goes to ``flash_attention``, the Mamba recurrence to
``ssm_scan`` and the RG-LRU recurrence to ``rglru_scan``, each through the
registry front door ``autotuned(name)`` (tuned once per shape class, then
recalled).  A call on CUDA tensors takes the kernel, a call on CPU tensors
the plain version, by the tensors' device; there is no fallback from one
to the other.  :func:`plain_versions` sends CUDA tensors to the plain
versions too, for a caller that holds the kernel route against them on the
card (``chip_smoke.py``); every plain call adds one to its kernel wrapper's
``counter.plain_calls``.
"""
from __future__ import annotations

from contextlib import contextmanager
from contextvars import ContextVar
from typing import Iterator

import torch

_PLAIN: ContextVar[bool] = ContextVar("repro_torch_models_plain", default=False)


@contextmanager
def plain_versions() -> Iterator[None]:
    """Inside, the models run the kernels' plain versions on any device."""
    token = _PLAIN.set(True)
    try:
        yield
    finally:
        _PLAIN.reset(token)


def on_kernel(t: torch.Tensor) -> bool:
    """True where a call on ``t`` takes the hand-written kernel."""
    return t.device.type == "cuda" and not _PLAIN.get()
