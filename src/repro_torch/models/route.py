"""Which version of a kernel a model's call takes, and at which point.

The model zoo reaches three of the port's hand-written kernels: causal
self-attention goes to ``flash_attention``, the Mamba recurrence to
``ssm_scan`` and the RG-LRU recurrence to ``rglru_scan``, each through the
registry front door ``autotuned(name)`` (tuned once per shape class, then
recalled).  A call on CUDA tensors takes the kernel, a call on CPU tensors
the plain version, by the tensors' device; there is no fallback from one
to the other.  :func:`plain_versions` sends CUDA tensors to the plain
versions too, for a caller that holds the kernel route against them on the
card (``chip_smoke.py``); every plain call adds one to its kernel wrapper's
``counter.plain_calls``.  Under autograd the plain versions are torch ops
and differentiate as they are; causal attention on the kernel route takes
the flash backward kernel (``attention.FlashAttentionFn``), and the two
scans, whose backward kernels are not written yet, raise
(:func:`no_backward`) rather than run a plain version or hand back a
result with no gradient.

The routing is per thread (context variables); what autograd runs later
on its own thread (a backward, remat's recompute) is bound to the routing
of the forward that recorded it (:func:`in_this_context`).

Serving never tunes on its hot path, inside the model included: the flash
shape class keys the exact sequence length, so every new prompt length
would tune flash inline on the request path.  The ``Server`` and the
``StreamingEngine`` run their model calls inside :func:`serving` with a
:class:`ServingRule`, and a kernel call there resolves by the rule, the
JAX ``Server``'s three modes: a DB hit runs the tuned point; a miss runs
the kernel's default point and goes to the rule's background tuner, or
tunes inline when the rule says ``inline_tune`` (counted as hot-path
evaluations), or is not tuned at all.
"""
from __future__ import annotations

import contextvars
import threading
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Any, Dict, Iterator, Optional

import torch

from ..core import TuningDB, autotuned
from ..core.autotuned import AutotunedOp, OpState

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


def in_this_context(fn):
    """``fn`` bound to the routing in force now (:func:`plain_versions`,
    :func:`serving`), wherever it runs later: autograd runs a backward, and
    remat's recompute, on its own thread, which would see neither."""
    ctx = contextvars.copy_context()
    return lambda *args, **kwargs: ctx.run(fn, *args, **kwargs)


def needs_grad(*ts: torch.Tensor) -> bool:
    """True where autograd will ask for the gradient of a call on ``ts``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def no_backward(name: str, *ts: torch.Tensor) -> None:
    """Raise where a kernel with no backward kernel yet would be asked for a
    gradient on the card: the plain version is not run in its place, and
    no tensor without a gradient is handed back."""
    if needs_grad(*ts):
        raise NotImplementedError(
            f"{name} has no backward kernel yet (ROADMAP.md §A item 6a, the scans' "
            f"backward kernels): a model that calls it trains on the CPU only "
            f"(device='cpu'), or under plain_versions()"
        )


class ServingRule:
    """How a kernel call resolves inside :func:`serving`.  The trainer
    runs its steps under one too, ``inline_tune`` on its TuningDB.

    Each kernel gets its own op on the serving DB (``autotuned(name,
    db=db)``).  With ``background`` (a
    :class:`~repro_torch.runtime.background_tuner.BackgroundTuner`) a miss
    is queued there; with ``inline_tune`` it tunes on the calling thread
    and its evaluations count in :attr:`hot_path_cost_evaluations`; with
    neither it runs the default point and is never tuned.
    """

    def __init__(self, db: TuningDB, background: Any = None, inline_tune: bool = False) -> None:
        self.db = db
        self.background = background
        self.inline_tune = inline_tune
        self._ops: Dict[str, AutotunedOp] = {}
        self._hot: Dict[str, OpState] = {}  # fingerprint -> state tuned inline
        self._lock = threading.Lock()

    def op(self, name: str) -> AutotunedOp:
        with self._lock:
            op = self._ops.get(name)
            if op is None:
                # a recalled class does not warm its runners-up here: the
                # kernels are built ahead, so warming compiles nothing and
                # would launch each of the top-k once on the request path
                op = self._ops[name] = autotuned(name, db=self.db, warm=False)
            return op

    def resolve(self, name: str, args: tuple) -> OpState:
        op = self.op(name)
        if self.background is not None:
            return self.background.submit(op, *args)
        if not self.inline_tune:
            return op.resolve_deferred(*args)
        before = op.states()
        state = op.resolve(*args)
        fp = state.bp.fingerprint()
        if state.tuned and fp not in before:
            with self._lock:
                self._hot[fp] = state
        return state

    @property
    def hot_path_cost_evaluations(self) -> int:
        with self._lock:
            return sum(st.cost_evaluations for st in self._hot.values())

    def states(self) -> Dict[str, OpState]:
        """Every kernel shape class resolved under this rule, by fingerprint."""
        with self._lock:
            ops = list(self._ops.values())
        out: Dict[str, OpState] = {}
        for op in ops:
            out.update(op.states())
        return out


_SERVING: ContextVar[Optional[ServingRule]] = ContextVar("repro_torch_models_serving",
                                                         default=None)


@contextmanager
def serving(rule: ServingRule) -> Iterator[None]:
    """Inside, kernel calls resolve by ``rule`` (on this thread only)."""
    token = _SERVING.set(rule)
    try:
        yield
    finally:
        _SERVING.reset(token)


def kernel_state(name: str, *args: Any) -> OpState:
    """The state a call of kernel ``name`` on ``args`` runs: by the serving
    rule inside :func:`serving`, else the registry op's (tuned on a miss)."""
    rule = _SERVING.get()
    if rule is None:
        return autotuned(name).resolve(*args)
    return rule.resolve(name, args)


def run_kernel(name: str, *args: Any) -> Any:
    """Launch kernel ``name`` on ``args`` at the point :func:`kernel_state`
    gives (outside serving, through the registry op's dispatch)."""
    rule = _SERVING.get()
    if rule is None:
        return autotuned(name)(*args)
    return rule.resolve(name, args).region(*args)
