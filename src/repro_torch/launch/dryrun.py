"""Multi-pod dry-run: trace every (arch × shape × mesh) cell on fake tensors.

The port of ``repro.launch.dryrun``.  This is FIBER before-execution AT
with the hardware absent: the candidate (sharding rule, remat policy,
microbatch degree, ...) is built as a step over DTensors of fake tensors
on a fake process group of the mesh's size (:mod:`.mesh`), placed by the
rule, and run once under a trace of one device's work
(:class:`~repro_torch.distributed.trace.StepTrace`).  Nothing is
allocated, on the card or the host.  JAX lowers and compiles the step
with ``in_shardings`` and reads XLA's ``memory_analysis()`` and HLO; the
port builds the same answers from the step itself:

* per-device memory: argument bytes from the local shards of the inputs,
  and the peak of live memory over the step from the trace;
* the three-term roofline (:func:`~repro_torch.core.cost.roofline_from_trace`)
  on an H100 cluster: the device's FLOPs, bytes and collectives;
* ``model_flops`` (:func:`~repro_torch.models.analytic_step_flops`) over
  the traced FLOPs of all devices, the useful-flops ratio.

The kernels run as their shape-only stand-ins (``models.route``), and the
outputs are redistributed to JAX's out-placements (train: parameters and
optimizer state as placed, the loss replicated; elsewhere every partial
sum resolved), which is where the step's last collectives happen.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/torch_dryrun.jsonl
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

from ..configs import ARCH_IDS, SHAPES, ShapeCell, all_cells, get_config, skipped_cells
from ..core.arch import ArchSpec
from ..core.cost import RooflineTerms, roofline_from_trace
from ..distributed.sharding import (
    RULES,
    activation_sharding,
    local_shape,
    logical_to_spec,
    opt_state_sharding,
    param_sharding,
    to_placements,
)
from ..models import (
    analytic_step_flops,
    decode_fn,
    input_logical_axes,
    input_specs,
    param_specs,
    prefill_fn,
)
from ..models.spec import ParamSpec
from ..optim import AdamWConfig, adamw_init_specs
from .mesh import make_production_mesh, n_chips

# the cluster the roofline prices: H100 SXM5 in nodes of 8 (core/arch.py)
H100_CLUSTER = ArchSpec(name="NVIDIA H100 80GB HBM3", backend="cuda")


def _map2(fn, a: Any, b: Any) -> Any:
    """``fn`` over the leaves of two trees of one structure (dicts, lists)."""
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in a}
    if isinstance(a, list):
        return [_map2(fn, x, y) for x, y in zip(a, b)]
    return fn(a, b)


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _placed(fake_mode, mesh, shape, dtype, spec):
    """A DTensor of ``shape`` whose local shard is a fake tensor, placed
    by ``spec`` on ``mesh``.  On a mesh of one device (``fake_mode`` None),
    where every placement is the whole tensor, a meta tensor itself: the
    step then runs the one-card path of the model code, op for op, on
    meta kernels."""
    import torch
    from torch.distributed.tensor import DTensor

    if fake_mode is None:
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    with fake_mode:
        local = torch.empty(local_shape(shape, spec, mesh), dtype=dtype)
    return DTensor.from_local(local, mesh.device_mesh, to_placements(spec, mesh),
                              run_check=False, shape=tuple(shape),
                              stride=_contiguous_stride(shape))


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def placed_specs(fake_mode, mesh, spec_tree: Any, specs: Any) -> Any:
    """The ParamSpec tree as DTensors of fake tensors, each placed by its
    spec in ``specs`` (a tree of the same structure)."""
    return _map2(lambda s, sp: _placed(fake_mode, mesh, s.shape, s.dtype, sp), spec_tree, specs)


def _input_specs(cfg, cell: ShapeCell, rule, mesh):
    """(input meta tensors, their specs under ``rule``)."""
    ins = input_specs(cfg, cell.kind, cell.global_batch, cell.seq_len)
    axes = input_logical_axes(cfg, cell.kind, ins)
    specs = {part: {k: logical_to_spec(rule, tuple(v.shape), axes[part][k], mesh)
                    for k, v in ins[part].items()} for part in ins}
    return ins, specs


def argument_specs(arch: str, cell: ShapeCell, mesh, rule_name: str = "tp",
                   opt_cfg: Optional[AdamWConfig] = None,
                   cfg_overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Every argument of the cell's step as ``(ParamSpec-like leaf, spec)``
    trees: ``params``, ``opt_state`` (train), ``batch``, ``cache``
    (decode).  Reads only ``mesh.shape``."""
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = cfg.with_(**cfg_overrides)
    rule = RULES[rule_name]
    specs = param_specs(cfg)
    out = {"params": (specs, param_sharding(rule, specs, mesh))}
    if cell.kind == "train":
        o_specs = adamw_init_specs(specs, opt_cfg or AdamWConfig())
        out["opt_state"] = (o_specs, opt_state_sharding(rule, o_specs, mesh))
    ins, in_specs = _input_specs(cfg, cell, rule, mesh)
    for part in ins:
        leaves = {k: ParamSpec(tuple(v.shape), (None,) * v.dim(), dtype=v.dtype)
                  for k, v in ins[part].items()}
        out[part] = (leaves, in_specs[part])
    return out


def argument_bytes(arch: str, cell: ShapeCell, mesh, rule_name: str = "tp",
                   opt_cfg: Optional[AdamWConfig] = None,
                   cfg_overrides: Optional[Dict[str, Any]] = None) -> int:
    """One device's bytes of the step's arguments: the local shard of every
    leaf, by its spec (no tensor is built)."""
    import torch

    sizes = []
    for leaves, specs in argument_specs(arch, cell, mesh, rule_name, opt_cfg,
                                        cfg_overrides).values():
        _map2(lambda leaf, spec: sizes.append(
            math.prod(local_shape(leaf.shape, spec, mesh))
            * torch.empty((), dtype=leaf.dtype).element_size()), leaves, specs)
    return sum(sizes)


@dataclass
class LoweredCell:
    """One cell's step, built and placed, not yet run: ``step()`` runs it
    on ``args`` (all DTensors of fake tensors) and returns its outputs at
    their out-placements."""

    mesh: Any
    rule: Any
    fake_mode: Any
    args: Tuple[Any, ...]
    step: Callable[..., Any]

    def compile(self) -> "TracedCell":
        """Run the step once under a trace of one device's work (the port's
        counterpart of XLA's compile: what it yields is the memory and cost
        analysis)."""
        import torch
        from torch.distributed.tensor.experimental import implicit_replication

        from ..distributed.trace import StepTrace

        trace = StepTrace(count_meta=self.fake_mode is None)
        with self.fake_mode or contextlib.nullcontext(), trace:
            trace.track(self.args)
            args_bytes = trace.live_bytes
            arg_storages = {_storage_key(t) for t in _local_leaves(self.args)}
            with activation_sharding(self.mesh, self.rule), implicit_replication():
                out = self.step(*self.args)
            outs = list(_local_leaves(out))
        seen, out_bytes, alias_bytes = set(), 0, 0
        for t in outs:
            key = _storage_key(t)
            if key in seen:
                continue
            seen.add(key)
            n = t.untyped_storage().nbytes()
            if key in arg_storages:
                alias_bytes += n
            out_bytes += n
        return TracedCell(trace, args_bytes, out_bytes, alias_bytes)


def _local_leaves(tree: Any):
    import torch

    for t in _leaves(tree):
        if isinstance(t, torch.Tensor):
            yield getattr(t, "_local_tensor", t)


def _storage_key(t) -> int:
    return t.untyped_storage()._cdata


@dataclass
class TracedCell:
    trace: Any
    argument_bytes: int
    output_bytes: int
    alias_bytes: int

    def memory(self) -> Dict[str, int]:
        """JAX's memory record, per device: the temporaries are what the
        step's peak holds beyond its arguments and outputs."""
        peak = self.trace.peak_bytes
        temp = max(0, peak - self.argument_bytes - self.output_bytes + self.alias_bytes)
        return {
            "argument_bytes": int(self.argument_bytes),
            "output_bytes": int(self.output_bytes),
            "temp_bytes": int(temp),
            "alias_bytes": int(self.alias_bytes),
            "per_device_total": int(self.argument_bytes + self.output_bytes + temp
                                    - self.alias_bytes),
        }


def lower_cell(
    arch: str,
    cell: ShapeCell,
    mesh,
    rule_name: str = "tp",
    opt_cfg: Optional[AdamWConfig] = None,
    cfg_overrides: Optional[Dict[str, Any]] = None,
    n_micro: int = 1,
    smoke: bool = False,
):
    """Build and place the step function for one cell (of the arch's SMOKE
    config with ``smoke``).  Returns ``(LoweredCell, cfg)``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Partial, Replicate

    cfg = get_config(arch, smoke=smoke)
    if cfg_overrides:
        cfg = cfg.with_(**cfg_overrides)
    rule = RULES[rule_name]
    fake_mode = FakeTensorMode(allow_non_fake_inputs=True) if mesh.size > 1 else None
    specs = param_specs(cfg)
    p_specs = param_sharding(rule, specs, mesh)
    params = placed_specs(fake_mode, mesh, specs, p_specs)
    ins, in_specs = _input_specs(cfg, cell, rule, mesh)
    batch = {k: _placed(fake_mode, mesh, v.shape, v.dtype, in_specs["batch"][k])
             for k, v in ins["batch"].items()}

    def resolved(t):
        """``t`` with every partial sum reduced (an output XLA would give)."""
        if any(isinstance(p, Partial) for p in getattr(t, "placements", ())):
            return t.redistribute(t.device_mesh, [Replicate() if isinstance(p, Partial) else p
                                                  for p in t.placements])
        return t

    if cell.kind == "train":
        from ..runtime.train import make_train_step

        opt_cfg = opt_cfg or AdamWConfig()
        o_specs_tree = adamw_init_specs(specs, opt_cfg)
        o_specs = opt_state_sharding(rule, o_specs_tree, mesh)
        opt_state = placed_specs(fake_mode, mesh, o_specs_tree, o_specs)
        step = make_train_step(cfg, opt_cfg, n_micro)
        p_pl = _map2(lambda s, sp: to_placements(sp, mesh), specs, p_specs)
        o_pl = _map2(lambda s, sp: to_placements(sp, mesh), o_specs_tree, o_specs)

        def placed(t, pl):
            return t.redistribute(t.device_mesh, pl) if hasattr(t, "device_mesh") else t

        def train_step(params, opt_state, batch):
            new_p, new_o, metrics = step(params, opt_state, batch)
            new_p = _map2(placed, new_p, p_pl)
            new_o = _map2(placed, new_o, o_pl)
            return new_p, new_o, placed(metrics["loss"], (Replicate(),) * len(mesh.shape))

        return LoweredCell(mesh, rule, fake_mode, (params, opt_state, batch),
                           train_step), cfg

    if cell.kind == "prefill":
        def prefill_step(params, batch):
            logits, cache = prefill_fn(params, batch, cfg)
            return resolved(logits), {k: resolved(v) if hasattr(v, "placements") else v
                                      for k, v in cache.items()}

        return LoweredCell(mesh, rule, fake_mode, (params, batch), prefill_step), cfg

    if cell.kind == "decode":
        cache = {k: _placed(fake_mode, mesh, v.shape, v.dtype, in_specs["cache"][k])
                 for k, v in ins["cache"].items() if k != "len"}
        # the cache's length: an int32 scalar among the arguments, and the
        # step's position (the cache holds seq_len - 1 tokens)
        length = _placed(fake_mode, mesh, (), ins["cache"]["len"].dtype, ())

        def serve_step(params, batch, cache, length):
            logits, out = decode_fn(params, batch, dict(cache, len=cell.seq_len - 1), cfg)
            return resolved(logits), {k: v for k, v in out.items() if k != "len"}, length + 1

        return LoweredCell(mesh, rule, fake_mode, (params, batch, cache, length),
                           serve_step), cfg

    raise ValueError(cell.kind)


def model_flops(cfg, cell: ShapeCell) -> float:
    """MODEL_FLOPS: 6·N·D / 2·N·D weight flops plus the attention/scan
    sequence terms (dominant at 32k+) — see models.analytic_step_flops."""
    return analytic_step_flops(cfg, cell.kind, cell.global_batch, cell.seq_len)


def mesh_name(multi_pod: bool, mesh_shape=None) -> str:
    if mesh_shape:
        return "pod" + "x".join(map(str, mesh_shape))
    return "pod2x16x16" if multi_pod else "pod16x16"


def run_cell(
    arch: str,
    cell: ShapeCell,
    multi_pod: bool,
    rule_name: str = "tp",
    verbose: bool = True,
    cfg_overrides: Optional[Dict[str, Any]] = None,
    opt_cfg: Optional[AdamWConfig] = None,
    n_micro: int = 1,
    label: str = "",
    mesh_shape=None,
    smoke: bool = False,
) -> Dict[str, Any]:
    """One cell's record (JAX's keys).  ``lower_s`` times building and
    placing the step's fake inputs; ``compile_s`` times the traced run."""
    mesh = make_production_mesh(multi_pod=multi_pod, shape=mesh_shape)
    chips = n_chips(mesh)
    t0 = time.time()
    lowered, cfg = lower_cell(arch, cell, mesh, rule_name, cfg_overrides=cfg_overrides,
                              opt_cfg=opt_cfg, n_micro=n_micro, smoke=smoke)
    t_lower = time.time() - t0
    t0 = time.time()
    traced = lowered.compile()
    t_compile = time.time() - t0

    memory = traced.memory()
    terms = roofline_from_trace(traced.trace, chips, H100_CLUSTER, memory["per_device_total"])
    mf = model_flops(cfg, cell)
    rec: Dict[str, Any] = {
        "arch": arch,
        "shape": cell.name,
        "kind": cell.kind,
        "mesh": mesh_name(multi_pod, mesh_shape),
        "chips": chips,
        "rule": rule_name,
        "n_micro": n_micro,
        "label": label,
        "overrides": cfg_overrides or {},
        "lower_s": round(t_lower, 2),
        "compile_s": round(t_compile, 2),
        "memory": memory,
        "roofline": terms.asdict(),
        "model_flops": mf,
        "useful_flops_ratio": mf / terms.hlo_flops if terms.hlo_flops else None,
        "status": "ok",
    }
    if verbose:
        print_record(rec, terms, t_lower, t_compile)
    return rec


def print_record(rec: Dict[str, Any], terms: RooflineTerms, t_lower: float,
                 t_compile: float) -> None:
    hbm_gib = rec["memory"]["per_device_total"] / 2**30
    print(
        f"[dryrun] {rec['arch']:22s} {rec['shape']:12s} {rec['mesh']:11s} "
        f"rule={rec['rule']:8s} lower={t_lower:6.1f}s compile={t_compile:6.1f}s "
        f"mem/dev={hbm_gib:7.2f}GiB "
        f"roofline: C={terms.compute_s:.3e}s M={terms.memory_s:.3e}s "
        f"X={terms.collective_s:.3e}s -> {terms.bottleneck} "
        f"useful={rec['useful_flops_ratio'] and round(rec['useful_flops_ratio'], 3)}"
    )


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=list(ARCH_IDS))
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--rule", default="tp", choices=list(RULES))
    ap.add_argument("--all", action="store_true", help="run every assigned cell")
    ap.add_argument("--multi-pod", action="store_true", help="2x16x16 mesh")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None, help="append JSONL results here")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args()

    done = set()
    if args.out and args.skip_existing and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    done.add((r["arch"], r["shape"], r["mesh"], r.get("rule", "tp")))
                except Exception:
                    pass

    if args.all:
        cells = all_cells()
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, SHAPES[args.shape])]

    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    results = []
    for arch, cell in cells:
        for multi_pod in meshes:
            name = mesh_name(multi_pod)
            if (arch, cell.name, name, args.rule) in done:
                print(f"[dryrun] skip existing {arch} {cell.name} {name}")
                continue
            try:
                rec = run_cell(arch, cell, multi_pod, args.rule)
            except Exception as e:
                rec = {
                    "arch": arch,
                    "shape": cell.name,
                    "mesh": name,
                    "rule": args.rule,
                    "status": "error",
                    "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-2000:],
                }
                print(f"[dryrun] FAIL {arch} {cell.name} {name}: {e}")
            results.append(rec)
            if args.out:
                os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")

    for arch, shape, reason in skipped_cells():
        print(f"[dryrun] skipped-by-rule {arch} {shape}: {reason}")

    n_ok = sum(1 for r in results if r.get("status") == "ok")
    print(f"[dryrun] {n_ok}/{len(results)} cells ok")
    if n_ok < len(results):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
