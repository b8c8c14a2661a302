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
and differentiate as they are; on the kernel route each kernel's gradient
is its backward kernel, through an ``autograd.Function``: causal attention
``attention.FlashAttentionFn``, the Mamba scan ``ssm.SelectiveScanFn``, the
RG-LRU scan ``rglru.LruScanFn``.

The routing is per thread (context variables); what autograd runs later
on its own thread (a backward, remat's recompute) is bound to the routing
of the forward that recorded it (:func:`in_this_context`).

The dry-run (``repro_torch.launch.dryrun``) runs the models on fake
tensors, held in DTensors on a fake process group.  There a call takes
neither the kernel nor the plain version (:func:`on_stand_in`): the plain
scans loop in Python over S, and plain attention forms the S x S scores
no kernel holds, which a memory count would include.  It takes the
kernel's shape-only stand-in: the kernel's outputs, in their shapes and
dtypes, from the same ``autograd.Function`` (so it saves what the kernel's
saves), and the kernel's FLOPs and bytes counted by formula into the
trace (``repro_torch.distributed.trace.count_work``).  On DTensors the
stand-in runs on each device's shards (:func:`run_on_shards`).  A CUDA
tensor never takes a stand-in; a real CPU tensor still takes the plain
version.

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
from typing import Any, Dict, Iterator, Optional, Tuple

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


def on_stand_in(t: torch.Tensor) -> bool:
    """True where a call on ``t`` takes the kernel's shape-only stand-in:
    a fake or meta tensor off the card (or a DTensor of one)."""
    if t.device.type == "cuda":
        return False
    from torch._subclasses.fake_tensor import is_fake

    local = getattr(t, "_local_tensor", t)
    return local.is_meta or is_fake(local)


def _nbytes(*ts: Any) -> int:
    return sum(t.numel() * t.element_size() for t in ts if isinstance(t, torch.Tensor))


def flash_stand_in(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """The causal flash forward's (o, lse), shapes only: o like q, lse
    (B, H, S) float32; 4·B·H·S²·hd/2 FLOPs (the causal half)."""
    from ..distributed.trace import count_work

    B, S, H, hd = q.shape
    o = torch.empty_like(q)
    lse = q.new_empty((B, H, S), dtype=torch.float32)
    count_work(2.0 * B * H * S * S * hd, _nbytes(q, k, v, o, lse))
    return o, lse


def flash_bwd_stand_in(q, k, v, o, lse, do):
    """The flash backward's (dq, dk, dv), shapes only: 2.5 times the
    forward's FLOPs."""
    from ..distributed.trace import count_work

    B, S, H, hd = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    count_work(2.5 * 2.0 * B * H * S * S * hd, _nbytes(q, k, v, o, lse, do, dq, dk, dv))
    return dq, dk, dv


def ssm_stand_in(x, dt, A, Bc, Cc, skip, final_state: bool):
    """The selective scan's y (B, S, D) float32, and with ``final_state`` h
    (B, D, N) float32, shapes only: 6 FLOPs an element of (B, S, D, N)."""
    from ..distributed.trace import count_work

    Bsz, S, D = x.shape
    N = A.shape[-1]
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    h = torch.empty((Bsz, D, N), dtype=torch.float32, device=x.device) if final_state else None
    count_work(6.0 * Bsz * S * D * N, _nbytes(x, dt, A, Bc, Cc, skip, y, h))
    return (y, h) if final_state else y


def ssm_bwd_stand_in(x, dt, A, Bc, Cc, skip, dy, dh):
    """The selective scan's six gradients, shapes only: twice the
    forward's FLOPs."""
    from ..distributed.trace import count_work

    Bsz, S, D = x.shape
    grads = tuple(torch.empty_like(t) for t in (x, dt, A, Bc, Cc, skip))
    count_work(12.0 * Bsz * S * D * A.shape[-1], _nbytes(x, dt, A, Bc, Cc, skip, dy, dh, *grads))
    return grads


def rglru_stand_in(x, r, i, lam):
    """The RG-LRU recurrence's h (B, S, W) float32, shapes only: 8 FLOPs
    an element."""
    from ..distributed.trace import count_work

    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    count_work(8.0 * x.numel(), _nbytes(x, r, i, lam, y))
    return y


def rglru_bwd_stand_in(x, r, i, lam, dy):
    """The RG-LRU recurrence's four gradients, shapes only."""
    from ..distributed.trace import count_work

    grads = tuple(torch.empty_like(t) for t in (x, r, i, lam))
    count_work(16.0 * x.numel(), _nbytes(x, r, i, lam, dy, *grads))
    return grads


def run_on_shards(fn, args, in_placements, out_placements, grad_placements=None):
    """``fn`` on each device's shards: every tensor of ``args`` (a plain
    tensor is taken as replicated) redistributed to its ``in_placements``
    and unwrapped, ``fn``'s tensor outputs wrapped back as DTensors with
    ``out_placements`` (None for an output that is None).
    ``grad_placements``, where given for an argument, is the placement its
    local gradient has (``Partial`` where each device's shard gets only a
    share of it)."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    local = []
    for n, (a, pl) in enumerate(zip(args, in_placements)):
        if isinstance(a, torch.Tensor):
            if not isinstance(a, DTensor):
                a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim, run_check=False)
            if tuple(a.placements) != tuple(pl):
                a = a.redistribute(mesh, pl)
            grad_pl = grad_placements[n] if grad_placements else None
            a = a.to_local(grad_placements=grad_pl) if grad_pl else a.to_local()
        local.append(a)
    out = fn(*local)

    def wrap(t, pl):
        return None if t is None else DTensor.from_local(t, mesh, pl, run_check=False)

    if isinstance(out, tuple):
        return tuple(wrap(t, pl) for t, pl in zip(out, out_placements))
    return wrap(out, out_placements)


def scan_placements(x, roles: Dict[str, Tuple[Optional[int], Optional[int]]]):
    """Per mesh axis, where a scan's operands keep their shards: where x
    (B, S, channels) is sharded on its batch or its channels, each operand
    stays sharded on its own axis of that kind, and everything is gathered
    on any other mesh axis (a sequence shard included: a scan runs the
    whole sequence).  ``roles`` maps each operand to its (batch axis,
    channel axis), None where it has none.  Returns {operand: placements}."""
    from torch.distributed.tensor import Replicate, Shard

    out: Dict[str, list] = {k: [] for k in roles}
    for p in x.placements:
        which = None
        if isinstance(p, Shard) and p.dim in (0, 2):
            which = 0 if p.dim == 0 else 1
        for kind, axes in roles.items():
            ax = None if which is None else axes[which]
            out[kind].append(Replicate() if ax is None else Shard(ax))
    return {k: tuple(v) for k, v in out.items()}


def in_this_context(fn):
    """``fn`` bound to the routing in force now (:func:`plain_versions`,
    :func:`serving`), wherever it runs later: autograd runs a backward, and
    remat's recompute, on its own thread, which would see neither."""
    ctx = contextvars.copy_context()
    return lambda *args, **kwargs: ctx.run(fn, *args, **kwargs)


def needs_grad(*ts: torch.Tensor) -> bool:
    """True where autograd will ask for the gradient of a call on ``ts``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


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
