"""Logical-axis sharding: rules are data, and rule choice is a tunable PP.

The port of ``repro.distributed.sharding``.  Every parameter
(:class:`repro_torch.models.spec.ParamSpec`) and the key activations carry
*logical* axis names.  A :class:`ShardingRule` maps logical names to mesh
axes; applying a rule yields a spec: a tuple with one entry per array
dimension (``None``, a mesh axis name, or a tuple of names), trailing
``None`` s stripped, entry for entry the JAX ``PartitionSpec``.  Because
the rule is an ordinary value, the before-execution tuner searches over
rules the same way the paper searches over loop variants: sharding layout
is the "directive position" at the distributed level.

Divisibility guard: a dimension is only sharded if its size divides the
mesh axis product; otherwise that axis silently stays replicated (e.g. 8 KV
heads on a 16-way model axis), as OpenMP threads idle when the loop is
shorter than the team.

The rule logic reads only ``mesh.shape``, a name -> size mapping, as the
JAX package's does.  :func:`to_placements` turns a spec into DTensor
placements on a :class:`Mesh` that holds a ``DeviceMesh``; it is kept apart
from the rule logic, so that logic is held against JAX's entry for entry.
"""
from __future__ import annotations

import contextlib
import math
from contextvars import ContextVar
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

AxisTarget = Union[None, str, Tuple[str, ...]]
Spec = Tuple[AxisTarget, ...]


def is_spec_leaf(x: Any) -> bool:
    """Duck-typed ParamSpec check (avoids a circular import with
    repro_torch.models, whose layer modules import ``constrain`` from here)."""
    return hasattr(x, "shape") and hasattr(x, "logical_axes")


class Mesh:
    """A named mesh: ``shape`` maps each axis name to its size, in mesh
    order.  ``device_mesh`` is the ``torch.distributed`` DeviceMesh that
    places tensors on it, or None for a mesh that only names a
    factorization (rule logic, BP keys)."""

    def __init__(self, shape: Mapping[str, int], device_mesh: Any = None) -> None:
        self.shape: Dict[str, int] = dict(shape)
        self.device_mesh = device_mesh

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


@dataclass(frozen=True)
class ShardingRule:
    """logical axis name -> mesh axis (or tuple of axes, or None)."""

    name: str
    mapping: Tuple[Tuple[str, AxisTarget], ...]

    @classmethod
    def make(cls, name: str, **mapping: AxisTarget) -> "ShardingRule":
        return cls(name, tuple(sorted(mapping.items())))

    def target(self, logical: Optional[str]) -> AxisTarget:
        if logical is None:
            return None
        return dict(self.mapping).get(logical)

    def asdict(self) -> Dict[str, AxisTarget]:
        return dict(self.mapping)


def _mesh_axis_size(mesh: Any, target: AxisTarget) -> int:
    if target is None:
        return 1
    if isinstance(target, str):
        return mesh.shape[target]
    return math.prod(mesh.shape[t] for t in target)


def logical_to_spec(
    rule: ShardingRule,
    shape: Sequence[int],
    logical_axes: Sequence[Optional[str]],
    mesh: Any,
) -> Spec:
    """The spec of one array, with the divisibility guard per axis."""
    entries = []
    used: set = set()
    for size, logical in zip(shape, logical_axes):
        target = rule.target(logical)
        if target is None:
            entries.append(None)
            continue
        axes = (target,) if isinstance(target, str) else tuple(target)
        # drop axes absent from this mesh (e.g. "pod" on the single-pod mesh)
        # or already consumed by an earlier dim of this array
        axes = tuple(a for a in axes if a in mesh.shape and a not in used)
        if not axes:
            entries.append(None)
            continue
        if size % _mesh_axis_size(mesh, axes) != 0:
            entries.append(None)  # replicate: "idle threads"
            continue
        used.update(axes)
        entries.append(axes[0] if len(axes) == 1 else axes)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def spec_for(
    rule: ShardingRule,
    shape: Sequence[int],
    logical_axes: Sequence[Optional[str]],
    mesh: Any,
) -> Spec:
    return logical_to_spec(rule, shape, logical_axes, mesh)


def _map_specs(tree: Any, one) -> Any:
    if is_spec_leaf(tree):
        return one(tree)
    if isinstance(tree, Mapping):
        return {k: _map_specs(v, one) for k, v in tree.items()}
    return [_map_specs(v, one) for v in tree]


def param_sharding(rule: ShardingRule, spec_tree: Any, mesh: Any) -> Any:
    """The spec of every leaf of a ParamSpec tree (dicts and lists)."""
    return _map_specs(spec_tree,
                      lambda s: logical_to_spec(rule, s.shape, s.logical_axes, mesh))


def _entry_axes(entry: AxisTarget) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def to_placements(spec: Spec, mesh: Mesh) -> Tuple[Any, ...]:
    """DTensor placements (one per mesh axis, in mesh order) of ``spec``:
    ``Shard(d)`` on each mesh axis that dimension d's entry names,
    ``Replicate()`` on the others.  A dimension sharded over several axes
    takes them in mesh order, major first, as a JAX ``PartitionSpec``
    tuple does.  A mesh axis of size 1 is ``Replicate()``: its one shard is
    the whole, and a size-1 shard would only stop DTensor from reshaping
    the dimension."""
    from torch.distributed.tensor import Replicate, Shard

    owner: Dict[str, int] = {}
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        order = [mesh.axis_names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec entry {entry} is not in mesh order {mesh.axis_names}")
        for a in axes:
            owner[a] = dim
    return tuple(Shard(owner[a]) if a in owner and mesh.shape[a] > 1 else Replicate()
                 for a in mesh.axis_names)


def local_shape(shape: Sequence[int], spec: Spec, mesh: Any) -> Tuple[int, ...]:
    """The shape of one device's shard of an array of ``shape`` under
    ``spec`` (the guard keeps every sharded dimension divisible)."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        out[dim] //= _mesh_axis_size(mesh, entry) if entry is not None else 1
    return tuple(out)


# ---------------------------------------------------------------------------
# Activation-sharding context (used by model code via `constrain`)
# ---------------------------------------------------------------------------

_ACTIVE: ContextVar[Optional[Tuple[Any, ShardingRule]]] = ContextVar(
    "repro_torch_active_sharding", default=None
)


@contextlib.contextmanager
def activation_sharding(mesh: Any, rule: ShardingRule):
    token = _ACTIVE.set((mesh, rule))
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def current_rule() -> Optional[ShardingRule]:
    ctx = _ACTIVE.get()
    return ctx[1] if ctx else None


def current_mesh() -> Optional[Any]:
    ctx = _ACTIVE.get()
    return ctx[0] if ctx else None


def mesh_fingerprint(mesh: Optional[Any]) -> str:
    """Canonical string for a mesh factorization, e.g. ``"data2xmodel4"``.

    ``"host"`` when no mesh is given (one card, unsharded serving).
    """
    if mesh is None:
        return "host"
    return "x".join(f"{a}{n}" for a, n in mesh.shape.items())


def mesh_bp_entries(mesh: Optional[Any] = None) -> Dict[str, str]:
    """BP entries keying tuned results to the mesh shape.

    A tuned winner is only valid under the factorization it was measured on
    (resharding from (data=16, model=16) to (data=32, model=8) changes
    collective paths and per-shard shapes), so each factorization gets its
    own TuningDB entries instead of silently reusing a stale winner.  When
    ``mesh`` is omitted, the mesh from the active :func:`activation_sharding`
    context (if any) is used.
    """
    if mesh is None:
        mesh = current_mesh()
    return {"mesh": mesh_fingerprint(mesh)}


def constrain(x: Any, logical_axes: Sequence[Optional[str]]) -> Any:
    """``x`` redistributed to the rule's placements for ``logical_axes``
    (JAX's ``with_sharding_constraint``); a no-op outside an
    :func:`activation_sharding` context, and on a tensor that is not a
    DTensor, so model code runs unsharded on one card unchanged."""
    ctx = _ACTIVE.get()
    if ctx is None:
        return x
    mesh, rule = ctx
    if len(logical_axes) != x.dim():
        raise ValueError(f"constrain: {logical_axes} vs rank {x.dim()}")
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    spec = logical_to_spec(rule, x.shape, logical_axes, mesh)
    placements = to_placements(spec, mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


# ---------------------------------------------------------------------------
# ZeRO-1 optimizer-state sharding
# ---------------------------------------------------------------------------


def zero_spec(
    rule: ShardingRule,
    shape: Sequence[int],
    logical_axes: Sequence[Optional[str]],
    mesh: Any,
    zero_axes: Tuple[str, ...] = ("data",),
) -> Spec:
    """Param spec + additionally shard the largest unsharded dim over
    ``zero_axes`` (ZeRO-1: optimizer state scattered over data parallels)."""
    base = logical_to_spec(rule, shape, logical_axes, mesh)
    entries = list(base) + [None] * (len(shape) - len(base))
    free = [a for a in zero_axes if mesh.shape.get(a, 1) > 1 and not _axis_used(entries, a)]
    if not free:
        return base
    zsize = math.prod(mesh.shape[a] for a in free)
    # largest unsharded, divisible dim
    cand = [
        (shape[i], i)
        for i in range(len(shape))
        if entries[i] is None and shape[i] % zsize == 0 and shape[i] >= zsize
    ]
    if not cand:
        return base
    _, dim = max(cand)
    entries[dim] = free[0] if len(free) == 1 else tuple(free)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def _axis_used(entries, axis: str) -> bool:
    for e in entries:
        if e == axis:
            return True
        if isinstance(e, tuple) and axis in e:
            return True
    return False


def zero_spec_layered(
    rule: ShardingRule,
    shape: Sequence[int],
    logical_axes: Sequence[Optional[str]],
    mesh: Any,
    layers: int,
    zero_axes: Tuple[str, ...] = ("data",),
) -> Spec:
    """:func:`zero_spec` of one layer's leaf of a stack of ``layers``, as
    the JAX package stacks them (a leading "layers" axis) and the port
    holds them (one leaf a layer).  Where the stack's ZeRO axes land on
    its layers axis (a leaf whose other dims are sharded or too small),
    they go onto the leaf's own dim that takes them, an already sharded
    one first: each device's shard keeps the size the stacked one gives
    it.  Where no dim takes them, the state stays as the parameter is."""
    stacked = zero_spec(rule, (layers,) + tuple(shape), ("layers",) + tuple(logical_axes),
                        mesh, zero_axes)
    entries = list(stacked) + [None] * (len(shape) + 1 - len(stacked))
    moved, rest = _entry_axes(entries[0]), entries[1:]
    if moved:
        order = list(mesh.shape)
        dims = sorted(range(len(shape)),
                      key=lambda d: (rest[d] is None, -shape[d], d))
        for d in dims:
            axes = tuple(sorted(_entry_axes(rest[d]) + moved, key=order.index))
            if shape[d] % _mesh_axis_size(mesh, axes) == 0:
                rest[d] = axes[0] if len(axes) == 1 else axes
                break
    while rest and rest[-1] is None:
        rest.pop()
    return tuple(rest)


def opt_state_sharding(
    rule: ShardingRule,
    opt_spec_tree: Any,
    mesh: Any,
    zero_axes: Tuple[str, ...] = ("data",),
) -> Any:
    """The ZeRO-1 spec of every leaf of the optimizer-state spec tree.  A
    list in the tree is a stack of layers (:func:`zero_spec_layered`)."""

    def walk(node, layers):
        if is_spec_leaf(node):
            if layers is None:
                return zero_spec(rule, node.shape, node.logical_axes, mesh, zero_axes)
            return zero_spec_layered(rule, node.shape, node.logical_axes, mesh, layers,
                                     zero_axes)
        if isinstance(node, Mapping):
            return {k: walk(v, layers) for k, v in node.items()}
        return [walk(v, len(node)) for v in node]

    return walk(opt_spec_tree, None)


# ---------------------------------------------------------------------------
# The candidate rule set (PP domain at the distributed level)
# ---------------------------------------------------------------------------

# Axis name conventions: mesh axes are "pod", "data", "model" (launch/mesh.py);
# logical names are the ParamSpec vocabulary + activation names
# ("batch", "seq", "act_embed", "act_ffn", "act_heads", "act_kv", "act_vocab",
#  "act_experts", "act_rnn").

def _base(name: str, **over: AxisTarget) -> ShardingRule:
    mapping: Dict[str, AxisTarget] = {
        # params
        "vocab": "model",
        "embed": None,
        "embed_table": None,
        "q_heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "ffn": "model",
        "experts": "model",
        "rnn": "model",
        "state": None,
        "conv": None,
        "layers": None,
        "frames": None,
        # activations
        "batch": ("pod", "data"),
        "seq": None,
        "act_embed": None,
        "act_ffn": "model",
        "act_heads": "model",
        "act_kv": "model",
        "act_vocab": "model",
        "act_experts": "model",
        "act_rnn": "model",
        "kv_slots": None,
        "moe_capacity": None,
    }
    mapping.update(over)
    return ShardingRule.make(name, **mapping)


RULES: Dict[str, ShardingRule] = {
    # Pure tensor parallel on `model`, pure data parallel on `pod`+`data`.
    "tp": _base("tp"),
    # ZeRO-3/FSDP-style: weights additionally sharded over `data` on their
    # embed axis; gathered at use, gradients reduce-scattered.
    "fsdp_tp": _base("fsdp_tp", embed="data"),
    # FSDP over both data axes (multi-pod weight sharding).
    "fsdp2_tp": _base("fsdp2_tp", embed=("pod", "data")),
    # Sequence parallelism for activations (long prefill): tokens sharded on
    # `model` along seq between attention/FFN regions.
    "tp_seq": _base("tp_seq", seq="model"),
    # Flash-decoding: the KV cache length dim sharded over `model` (softmax
    # over a sharded axis: local max/sum, then max/sum all-reduces).  The
    # decode answer when kv_heads < model-axis size (all 10 assigned archs).
    "tp_kvseq": _base("tp_kvseq", kv_slots="model"),
    # Expert parallel with data-sharded dispatch capacity: the MoE (E, C, d)
    # buffer partitions over (experts->model, capacity->data), turning the
    # dispatch into an all-to-all instead of a replicated all-reduce.
    "tp_ep": _base("tp_ep", moe_capacity=("pod", "data")),
    "fsdp_tp_ep": _base("fsdp_tp_ep", embed="data", moe_capacity=("pod", "data")),
}
