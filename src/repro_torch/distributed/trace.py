"""What one device does in a step on fake tensors: FLOPs, bytes, collectives
and the peak of live memory.

The dry-run's stand-in for XLA's per-device HLO walk and
``memory_analysis()``.  :class:`StepTrace` is a ``TorchDispatchMode`` that
sees the *local* ops of a step run on DTensors of fake tensors: it returns
``NotImplemented`` for an op on DTensors, so DTensor dispatches it and its
per-shard ops come back to the mode on plain fake tensors.  For each of
them it counts

* FLOPs, by ``torch.utils.flop_counter``'s formulas (the matmuls,
  convolutions and attention ops; elementwise work is not counted);
* bytes, each input and output of an op that moves data (views, creation
  and the collectives' waits move none);
* collectives (``_c10d_functional``): kind, payload bytes and the ranks of
  the group, so the roofline charges a group that spans nodes at the
  inter-node rate;
* live memory: each new storage is added when an op makes it and taken
  off when it is freed (a weak reference), and the peak is kept.  Tensors
  that exist before the step (parameters, optimizer state, inputs) are
  added with :meth:`StepTrace.track`.

DTensor's sharding propagation runs each op once more on fake tensors of
the global shape, to learn the output's metadata; those ops are not the
device's, and the trace skips them (:func:`_mark_propagation`).

Work that a kernel does, where the dry-run runs the kernel's shape-only
stand-in (:mod:`repro_torch.models.route`), is counted by formula through
:func:`count_work`.
"""
from __future__ import annotations

import functools
import threading
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack
from torch.utils._pytree import tree_flatten

# collective ops of torch.distributed's functional collectives, by the
# JAX package's HLO names
_COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}
# ops that move no bytes: views and aliases, allocation, a collective's wait
_NO_TRAFFIC = {
    "view", "_unsafe_view", "reshape", "expand", "t", "transpose", "permute", "unsqueeze",
    "squeeze", "slice", "select", "alias", "detach", "as_strided", "split", "split_with_sizes",
    "unbind", "chunk", "narrow", "diagonal", "unfold", "view_as_real", "view_as_complex",
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "lift_fresh",
    "wait_tensor", "_to_copy_view", "sym_size", "sym_stride", "sym_numel", "is_same_size",
}


class _Propagating:
    """The hook DTensor's sharding propagator enters around its global-shape
    fake run (``ShardingPropagator._fake_mode_lock``): while inside, the
    trace counts nothing."""

    def __init__(self) -> None:
        self._local = threading.local()

    @property
    def depth(self) -> int:
        return getattr(self._local, "depth", 0)

    def __enter__(self):
        self._local.depth = self.depth + 1
        return self

    def __exit__(self, *exc) -> None:
        self._local.depth -= 1


def _mark_propagation(flag: _Propagating):
    """Enter ``flag`` around DTensor's global-shape meta propagation, by
    the hook this torch offers: the propagator's lock
    (``ShardingPropagator._fake_mode_lock``) where it has one, else its
    propagation method, wrapped.  Returns the function that undoes it."""
    try:
        from torch.distributed.tensor._sharding_prop import ShardingPropagator as SP
    except ImportError:
        return lambda: None
    if hasattr(SP, "_fake_mode_lock"):
        saved = SP._fake_mode_lock
        SP._fake_mode_lock = flag
        return lambda: setattr(SP, "_fake_mode_lock", saved)
    for name in ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta"):
        fn = SP.__dict__.get(name)
        if fn is not None:
            def wrapped(self, *args, _fn=fn, **kwargs):
                with flag:
                    return _fn(self, *args, **kwargs)

            setattr(SP, name, wrapped)
            return lambda name=name, fn=fn: setattr(SP, name, fn)
    return lambda: None


class StepTrace(TorchDispatchMode):
    """One device's work in a step (see the module docstring).  With
    ``count_meta`` False, meta tensors (shape holders beside fake ones) hold
    no memory of the device."""

    def __init__(self, count_meta: bool = True) -> None:
        super().__init__()
        self.count_meta = count_meta
        self.flops = 0.0
        self.bytes = 0.0
        # kind -> payload bytes; and every call: (kind, bytes, the group's ranks)
        self.collectives: Dict[str, float] = {}
        self.collective_calls: List[Tuple[str, int, Tuple[int, ...]]] = []
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: Dict[int, Any] = {}  # id of a live storage -> its weak reference
        self._lock = threading.Lock()
        self._propagating = _Propagating()
        self._unpatch: Any = None
        self._groups: Dict[str, Tuple[int, ...]] = {}

    # -- entering and leaving ---------------------------------------------

    def __enter__(self):
        self._unpatch = _mark_propagation(self._propagating)
        return super().__enter__()

    def __exit__(self, *exc):
        self._unpatch()
        return super().__exit__(*exc)

    # -- memory -------------------------------------------------------------

    def track(self, *trees: Any) -> None:
        """Count the storages of every tensor in ``trees`` as live (a
        DTensor by its local shard)."""
        for tree in trees:
            for t in tree_flatten(tree)[0]:
                if isinstance(t, torch.Tensor):
                    self._track(t)

    def _track(self, t: torch.Tensor) -> None:
        local = getattr(t, "_local_tensor", None)
        if local is not None:
            t = local
        if t.is_meta and not self.count_meta:
            return
        st = t.untyped_storage()
        key = id(st)
        with self._lock:
            if key in self._live:
                return
            n = st.nbytes()
            self._live[key] = weakref.ref(st, lambda _, key=key, n=n: self._free(key, n))
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _free(self, key: int, n: int) -> None:
        with self._lock:
            self._live.pop(key, None)
            self.live_bytes -= n

    # -- counting -----------------------------------------------------------

    def add_work(self, flops: float, nbytes: float) -> None:
        with self._lock:
            self.flops += float(flops)
            self.bytes += float(nbytes)

    def _group_ranks(self, name: str) -> Tuple[int, ...]:
        ranks = self._groups.get(name)
        if ranks is None:
            import torch.distributed as dist
            from torch.distributed.distributed_c10d import _resolve_process_group

            ranks = tuple(dist.get_process_group_ranks(_resolve_process_group(name)))
            self._groups[name] = ranks
        return ranks

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, _dtensor()) for t in types):
            return NotImplemented  # DTensor runs it; its local ops come back here
        out = func(*args, **kwargs)
        if self._propagating.depth:
            return out
        packet = func._overloadpacket
        name = packet.__name__
        ins = _tensors(args) + _tensors(kwargs.values())
        outs = _tensors((out,))
        formula = _flop_formulas().get(packet)
        with self._lock:
            kind = _COLLECTIVES.get(name) if func.namespace == "_c10d_functional" else None
            if kind is not None:
                group = kwargs.get("group_name", args[-1] if args else None)
                payload = (sum(t.nbytes for t in outs) if kind == "all-gather"
                           else sum(t.nbytes for t in ins))
                self.collectives[kind] = self.collectives.get(kind, 0.0) + payload
                self.collective_calls.append((kind, payload, self._group_ranks(str(group))))
            elif name not in _NO_TRAFFIC:
                self.bytes += float(sum(t.nbytes for t in ins) + sum(t.nbytes for t in outs))
            if formula is not None:
                self.flops += float(formula(*args, **kwargs, out_val=out))
        if name != "wait_tensor":  # a wait returns its input's storage
            for t in outs:
                self._track(t)
        return out


def _tensors(items) -> List[torch.Tensor]:
    """The tensors among ``items`` and the lists and tuples in them."""
    out: List[torch.Tensor] = []
    for a in items:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(t for t in a if isinstance(t, torch.Tensor))
    return out


@functools.lru_cache(maxsize=None)
def _dtensor():
    from torch.distributed.tensor import DTensor

    return DTensor


@functools.lru_cache(maxsize=None)
def _flop_formulas():
    from torch.utils.flop_counter import flop_registry

    return flop_registry


def active_trace() -> Optional[StepTrace]:
    """The innermost :class:`StepTrace` on this thread's dispatch-mode
    stack (autograd's thread inherits the stack), or None."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, StepTrace):
            return mode
    return None


def count_work(flops: float, nbytes: float) -> None:
    """Add a kernel's work, counted by formula, to the active trace (if any)."""
    trace = active_trace()
    if trace is not None:
        trace.add_work(flops, nbytes)
