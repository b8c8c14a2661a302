"""The runner of a training cell (``"kind": "train"``).

Set-up builds one ``Trainer`` of the program over weights drawn from the
seed and AdamW state from the program's ``adamw_init``, and drives its
step (``Trainer.region`` under the Trainer's ``serving(rule)``, as
``Trainer.run`` does) through the job's ``checked_steps`` first steps on
batches that all differ.  The first of them tunes the step's kernel shape
classes on the cell's TuningDB (or recalls them).  From those steps it
keeps what the reference is held to: each step's loss, each leaf's norm of
the first gradient as AdamW got it (its first moment over 1 - b1), and
each leaf's norm of the change of the parameters over the steps.  The same
object then runs the window: step after step, each on a new batch copied
in from the host and its loss read, until ``--seconds`` have passed.

After the window the program's state is freed and the float32 reference
(the configuration's reference module's ``loss``, found by name:
:mod:`harness.family`) follows the checked steps from the same weights,
drawn again from the seed.
"""
from __future__ import annotations

import math
import statistics
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from . import device as dev
from . import family, traffic, weights
from .outcome import Outcome, free, leaf_gaps, moving_leaves, numbers_of, set_up_phases
from .trace import profiled, reduce, span


def model_config(config: Dict[str, Any], job: Dict[str, Any]):
    from repro_torch.models.config import ModelConfig

    kw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in config["model"].items()}
    cfg = ModelConfig(**kw)
    return cfg.with_(remat=job["remat"]) if "remat" in job else cfg


def batch_on(torch, rows: Dict[str, Any], device) -> Dict[str, Any]:
    return {k: torch.from_numpy(v).to(device) for k, v in rows.items()}


@dataclass
class Prepared:
    """What set-up hands the window: the program's one ``Trainer``, the step
    it drives (its own ``region``, or that wrapped by a fault), the state
    after the checked steps, what those steps read, and when set-up's
    phases ended."""

    cfg: Any
    trainer: Any
    step: Callable
    params: Any
    opt_state: Any
    readings: Dict[str, Any]
    phases: List[Tuple[str, float]]


def setup(cell, seed: int, device: Any, cache_dir,
          hook: Optional[Callable] = None) -> Prepared:
    """Build the program's ``Trainer`` over weights drawn from ``seed`` and
    drive its step through the checked steps.  ``hook(trainer)``,
    where given, wraps the program's step (the fault tests break it
    underneath)."""
    import torch

    from repro_torch.core import TuningDB
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime import Trainer, TrainLoopConfig

    config, job = cell.config, cell.job
    cfg = model_config(config, job)
    opt_cfg = AdamWConfig(**job["adamw"])
    loop = TrainLoopConfig(total_steps=1, n_microbatches=1, microbatch_candidates=(1,),
                           remat_candidates=(cfg.remat,), seed=seed)
    cache_dir.mkdir(parents=True, exist_ok=True)
    trainer = Trainer(cfg, opt_cfg, loop, tuning_db=TuningDB(str(cache_dir / "tuning.json")),
                      device=device)
    step = trainer.region if hook is None else hook(trainer)
    phases = [("program built", time.perf_counter())]
    params = weights.draw(config, seed, device)
    opt_state = adamw_init(params, opt_cfg)
    phases.append(("weights drawn", time.perf_counter()))
    params, opt_state, readings = checked_steps(torch, trainer, step, params, opt_state, job,
                                                seed, device)
    phases.append(("checked steps", time.perf_counter()))
    return Prepared(cfg, trainer, step, params, opt_state, readings, phases)


def run(cell, seed: int, seconds: float, trace_on: bool, t0: float, device: Any,
        cache_dir, clocks: dev.ClockLog, hook: Optional[Callable] = None) -> Outcome:
    """One run of a training cell; ``hook`` as :func:`setup` takes it."""
    import torch

    from repro_torch.models import serving
    from reference.common import F32

    config, job = cell.config, cell.job
    p = setup(cell, seed, device, cache_dir, hook)
    cfg, trainer, step, params, opt_state = p.cfg, p.trainer, p.step, p.params, p.opt_state
    vocab = cfg.vocab_size
    evals_before = sum(st.cost_evaluations for st in trainer.rule.states().values())

    # the window
    if device.type == "cuda":
        torch.cuda.synchronize()
    clocks.sample("window start")
    steps = nonfinite = 0
    with profiled(trace_on) as prof:
        t_start = time.perf_counter()
        with span("bench.window"):
            i = job["checked_steps"]
            while True:
                with span("bench.batch_copy_in"):
                    batch = batch_on(torch, traffic.train_rows(job, vocab, seed, i), device)
                with span("bench.step"), serving(trainer.rule):
                    params, opt_state, metrics = step(params, opt_state, batch)
                with span("bench.loss_read"):
                    loss = float(metrics["loss"])
                steps += 1
                i += 1
                nonfinite += not math.isfinite(loss)
                if time.perf_counter() - t_start >= seconds:
                    break
            if device.type == "cuda":
                torch.cuda.synchronize()
        window_s = time.perf_counter() - t_start
    clocks.sample("window end")
    setup_s = t_start - t0
    phases = set_up_phases(t0, p.phases, t_start)
    evals = sum(st.cost_evaluations for st in trainer.rule.states().values()) - evals_before
    peak = dev.peak_bytes(torch, 1) if device.type == "cuda" else 0
    trace = reduce(prof) if prof is not None else None
    readings = p.readings
    del p, trainer, params, opt_state, metrics, batch, step
    free(torch, device)

    # the reference follows the checked steps from the same weights
    t_ref = time.perf_counter()
    ref = reference_readings(torch, config, job, seed, device, F32)
    ref_s = time.perf_counter() - t_ref
    checks, where = compare(readings, ref, job["checks"])
    losses = readings["loss"]
    tokens = steps * job["batch"] * job["seq"]
    details = [phases,
        f"[train] {cfg.name} B={job['batch']} S={job['seq']} remat {cfg.remat}: {steps} steps "
        f"in {window_s:.3f} s, {tokens / window_s:.1f} tokens/s; set-up {setup_s:.3f} s; "
        f"evaluations in the window {evals}",
        f"[check] losses {losses} reference {ref['loss']}; worst gradient leaf "
        f"{where['grad_gap']}, worst change leaf {where['update_gap']}; {where['moving']} of "
        f"{len(ref['change'])} leaves compared for the change; reference {ref_s:.1f} s; "
        f"numbers {where['numbers']}; reference notes {ref.get('notes', {})}",
    ]
    return Outcome(
        setup_s=setup_s, window_s=window_s,
        end_to_end={"train_tokens_per_s": tokens / window_s},
        attempted=steps, failed=nonfinite,
        checks=checks,
        memory_peak_bytes=peak,
        counters={"steps": steps, "tokens": tokens, "batch": job["batch"], "seq": job["seq"],
                  "hot_path_evaluations": evals},
        trace=trace, config=config, job=job, details=details,
    )


def _to_float32(tree):
    if isinstance(tree, dict):
        return {k: _to_float32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_float32(v) for v in tree]
    return tree.float()


def checked_steps(torch, trainer, step, params, opt_state, job: Dict[str, Any], seed: int,
                  device) -> Tuple[Any, Any, Dict[str, Any]]:
    """The job's first ``checked_steps`` steps through ``step`` (the
    Trainer's own call) under the Trainer's rule, on the first batches of
    the seed; returns the state after them and what the reference is held
    to: the losses, each leaf's first gradient as AdamW got it (its first
    moment over 1 - b1) and each leaf's change over the steps, by name."""
    from repro_torch.models import serving

    b1 = job["adamw"]["b1"]
    vocab = trainer.cfg.vocab_size
    start = [t for _, t in weights.leaves_of(params)]
    losses, grad = [], {}
    for i in range(job["checked_steps"]):
        batch = batch_on(torch, traffic.train_rows(job, vocab, seed, i), device)
        with serving(trainer.rule):
            params, opt_state, metrics = step(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if i == 0:
            grad = {n: float(torch.linalg.vector_norm(m.float())) / (1 - b1)
                    for n, m in weights.leaves_of(opt_state["m"])}
    change = {n: float(torch.linalg.vector_norm(t.float() - s.float()))
              for (n, t), s in zip(weights.leaves_of(params), start)}
    return params, opt_state, {"loss": losses, "grad": grad, "change": change}


def reference_readings(torch, config: Dict[str, Any], job: Dict[str, Any], seed: int, device,
                       mm, half_batch: bool = False) -> Dict[str, Any]:
    """The reference's losses, first gradients and changes over the checked
    steps, from the weights drawn again from ``seed``, in float32 (``mm``
    the control's product where given), and what its ``notes`` read of the
    first batch (the configuration's reference module: :mod:`family`)."""
    from reference import training
    from reference.common import full_float32

    full_float32()
    ref = family.reference_of(config)
    m = family.sizes(config)
    params = _to_float32(weights.draw(config, seed, device))
    vocab = config["model"]["vocab_size"]
    batches = [batch_on(torch, traffic.train_rows(job, vocab, seed, i), device)
               for i in range(job["checked_steps"])]
    notes = ref.notes(params, batches[0], m) if hasattr(ref, "notes") and not half_batch else {}
    out = training.follow(ref.loss, params, batches, m, job["adamw"], mm, half_batch)
    out["notes"] = notes
    del params, batches
    free(torch, device)
    return out


def compare(program: Dict[str, Any], ref: Dict[str, Any], limits: Dict[str, float]):
    """The numbers compared, each beside its limit (those ``limits`` names),
    and every number the comparison reads, with where the worst leaves are:
    the losses' widest gap (``loss_gap``) and the first step's
    (``loss_gap_first``); the gap of the first gradient's norm at the worst
    leaf (``grad_gap``) and at the median leaf (``grad_gap_median``); the
    same of the change's norm (``update_gap``, ``update_gap_median``) over
    the leaves whose reference gradient is not nought to rounding."""
    grads = leaf_gaps(program["grad"], ref["grad"])
    moving = moving_leaves(ref["grad"])
    changes = leaf_gaps(program["change"], ref["change"], moving)
    numbers = {
        "loss_gap": max(abs(a - b) for a, b in zip(program["loss"], ref["loss"])),
        "loss_gap_first": abs(program["loss"][0] - ref["loss"][0]),
        "grad_gap": max(grads.values()),
        "grad_gap_median": statistics.median(grads.values()),
        "update_gap": max(changes.values()),
        "update_gap_median": statistics.median(changes.values()),
    }
    checks = {name: (numbers[name], limit) for name, limit in limits.items()}
    where = {"grad_gap": max(grads, key=grads.get), "update_gap": max(changes, key=changes.get),
             "moving": len(moving), "numbers": numbers}
    return checks, where


def readings(cell, seeds: Iterable[int], control_seeds: Iterable[int], device,
             cache_dir, say: Callable[[str], None] = print) -> List[Dict[str, Any]]:
    """The readings the cell's limits are set from (:mod:`harness.control`):
    on each seed the program's checked steps against the float32
    reference; on the control's seeds also the reference computed in 8-bit
    floats in the program's place, the reference trained on half of each
    batch, and a step that returns its state unchanged."""
    import torch

    from reference.common import F32, FP8

    config, job = cell.config, cell.job
    control_seeds = set(control_seeds)
    rows = []
    for seed in seeds:
        program = setup(cell, seed, device, cache_dir).readings
        free(torch, device)
        ref = reference_readings(torch, config, job, seed, device, F32)
        row = {"seed": seed, "program": numbers_of(compare(program, ref, job["checks"])),
               "notes": ref["notes"]}
        if seed in control_seeds:
            low = reference_readings(torch, config, job, seed, device, FP8)
            row["control"] = numbers_of(compare(low, ref, job["checks"]))
            half = reference_readings(torch, config, job, seed, device, F32, half_batch=True)
            row["half_batch"] = numbers_of(compare(half, ref, job["checks"]))
            # a step that returns its state unchanged: no gradient, no change
            still = {"loss": [ref["loss"][0]] * len(ref["loss"]),
                     "grad": {n: 0.0 for n in ref["grad"]},
                     "change": {n: 0.0 for n in ref["change"]}}
            row["unchanged"] = numbers_of(compare(still, ref, job["checks"]))
        say(f"[calibrate] {cell.name} {row}")
        rows.append(row)
    return rows
