"""Fault-tolerant training loop with run-time AT integration.

The port of ``repro.runtime.train``:

* **the step is functional**, as the jitted JAX step is:
  ``step(params, opt_state, batch) -> (params, opt_state, metrics)`` over
  parameter trees (:mod:`repro_torch.tree`) and returns new ones, leaving
  its arguments as they were, so the joint tuner's trial steps on the live
  state train nothing.  Gradients come from ``torch.autograd.grad`` of
  :func:`repro_torch.models.train_loss`: on the card causal attention runs
  forward and backward on the flash kernels.
* **checkpoint/restart** — atomic saves every N steps; on start the loop
  restores the latest checkpoint and replays the data stream from that step
  (the dataset is pure in (seed, step)), so an interrupted run gives
  bit-identical losses: every sum of the step runs in a fixed order (the
  flash backward has no atomics; the embedding's backward is deterministic,
  ``models.layers.Embed``).
* **failure injection** — ``failure_hook(step)`` may raise
  :class:`SimulatedFailure`; ``run()`` treats it as a node loss: tear down
  step state, restore, continue.
* **straggler mitigation** — the step for every microbatch degree is a
  candidate of one registry op (``train_step/<arch>``); a
  ``RuntimeSelector`` watches measured step times and re-selects the
  next-best degree when the current one regresses past the tolerance.
* **gradient accumulation degree** — the global batch is split into
  ``n_microbatches`` chunks run one after another, their float32 gradients
  summed and divided by the degree: less activation memory, more
  sequential steps.
* **joint AT** (``joint_tune``) — the (microbatch degree × remat
  directive) pair is tuned against the measured full step, and the winner
  persists in the TuningDB under the program fingerprint.

Before it measures a joint assignment or times the loop, the Trainer runs
one untimed warm step (:meth:`Trainer.warm`), so every kernel shape class
the step reaches (the flash forward's and backward's) is tuned or recalled
there, not inside a measured step.  ``device_key`` namespaces the train
step's BP and the joint program's fingerprint under the card's
:class:`~repro_torch.fleet.DeviceFingerprint`, so a fleet-shared TuningDB
never hands this host another device's winner.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Any, Callable, ContextManager, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..core import (
    ATRegion,
    AutotunedOp,
    BasicParams,
    KernelSpec,
    ParamSpace,
    PerfParam,
    ProgramMember,
    ProgramResult,
    ProgramSpec,
    TuningDB,
    register_kernel,
)
from ..models import ServingRule, init_params, serving, train_loss
from ..models.config import ModelConfig
from ..optim import AdamWConfig, adamw_init, adamw_update
from ..tree import as_tree, flatten, tree_map, unflatten


class SimulatedFailure(RuntimeError):
    """Stand-in for a node loss / preemption in tests and drills."""


@dataclass
class TrainLoopConfig:
    total_steps: int = 100
    log_every: int = 10
    ckpt_dir: Optional[str] = None
    save_every: int = 50
    keep_checkpoints: int = 3
    n_microbatches: int = 1
    microbatch_candidates: Sequence[int] = (1, 2, 4)
    straggler_tolerance: float = 3.0
    seed: int = 0
    # whole-program joint AT: tune (microbatch degree × remat directive)
    # against the measured full train step before the loop starts.  The two
    # knobs are the paper's pair (remat the directive change, the degree the
    # thread-count analogue) and both trade activation memory against time.
    joint_tune: bool = False
    joint_cap: Optional[int] = 16
    joint_k: Optional[int] = None
    remat_candidates: Sequence[str] = ("none", "full")
    # fleet device keying: namespace the train step's BP and the joint
    # program's fingerprint under the training device's DeviceFingerprint
    device_key: bool = False


def batch_tensors(batch: Dict[str, Any], device: Any) -> Dict[str, torch.Tensor]:
    """A dataset batch (numpy arrays) as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in batch.items()}


def _microbatches(batch: Dict[str, torch.Tensor], n: int) -> List[Dict[str, torch.Tensor]]:
    """The batch cut into ``n`` chunks of rows, in order; M-RoPE positions
    (3, B, S) are cut on axis 1."""
    out: List[Dict[str, torch.Tensor]] = [{} for _ in range(n)]
    for key, v in batch.items():
        axis = 1 if key == "positions" and v.dim() == 3 and v.shape[0] == 3 else 0
        if v.shape[axis] % n:
            raise ValueError(f"{key}: batch {v.shape[axis]} does not split into {n}")
        for i, chunk in enumerate(torch.chunk(v, n, dim=axis)):
            out[i][key] = chunk
    return out


def _loss_and_grads(leaves: List[torch.Tensor], structure: Any, batch, cfg: ModelConfig):
    """(loss, gradient of every leaf) of one batch; a leaf the loss does not
    reach gets zeros, as ``jax.grad`` gives."""
    work = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss = train_loss(unflatten(structure, work), batch, cfg)
        grads = torch.autograd.grad(loss, work, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return loss.detach(), grads


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, n_microbatches: int) -> Callable:
    """The pure train step for one microbatch degree (the dry-run traces it
    on DTensors of fake tensors, ``repro_torch.launch.dryrun``)."""

    def step_fn(params, opt_state, batch):
        leaves, structure = flatten(params)
        if n_microbatches == 1:
            loss, grads = _loss_and_grads(leaves, structure, batch, cfg)
        else:
            # zeros like each leaf (a DTensor's shards in the dry-run)
            gsum = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
            loss = 0.0
            for mb in _microbatches(batch, n_microbatches):
                mloss, mgrads = _loss_and_grads(leaves, structure, mb, cfg)
                torch._foreach_add_(gsum, [g.float() for g in mgrads])
                loss = loss + mloss
                del mgrads
            grads = torch._foreach_div(gsum, float(n_microbatches))
            del gsum
            loss = loss / n_microbatches
        params, opt_state, metrics = adamw_update(
            unflatten(structure, grads), opt_state, params, opt_cfg)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step_fn


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Trainer:
    def __init__(
        self,
        cfg: ModelConfig,
        opt_cfg: AdamWConfig,
        loop_cfg: TrainLoopConfig,
        tuning_db: Optional[TuningDB] = None,
        device: Any = "cuda",
    ) -> None:
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.loop = loop_cfg
        self.device = torch.device(device)
        self.db = tuning_db or TuningDB()
        self.ckpt = (
            CheckpointManager(
                loop_cfg.ckpt_dir, loop_cfg.save_every, loop_cfg.keep_checkpoints
            )
            if loop_cfg.ckpt_dir
            else None
        )
        self.straggler_events = 0
        self.restarts = 0
        # kernel calls of the steps resolve on this Trainer's TuningDB,
        # tuned inline on a miss, so a later Trainer on the DB recalls them
        self.rule = ServingRule(self.db, inline_tune=True)

        # The train step is a registry op like any kernel: the microbatch
        # degree is its PP, and its shape class is fixed by (arch, candidate
        # degrees, device).  The configured degree is pinned rather than
        # wall-clock-tuned so restarted runs stay bit-deterministic;
        # joint_tune replaces the pin with a whole-program search whose cost
        # is the measured full step.  The remat directive lives in a mutable
        # cell so a joint winner hot-applies without rebuilding the region.
        degrees = tuple(loop_cfg.microbatch_candidates)
        self._step_remat = cfg.remat
        bp = BasicParams.make(arch=cfg.name, kind="train_runtime", micro=degrees,
                              backend=self.device.type, framework="torch")
        if loop_cfg.device_key:
            from ..fleet.fingerprint import device_bp_entries

            bp = bp.with_entries(**device_bp_entries(self.device))
        spec = register_kernel(
            KernelSpec(
                name=f"train_step/{cfg.name}",
                make_region=lambda _bp: ATRegion(
                    name="train_step",
                    space=ParamSpace([PerfParam("n_micro", degrees)]),
                    instantiate=lambda pt: make_train_step(
                        cfg.with_(remat=self._step_remat), opt_cfg, pt["n_micro"]),
                ),
                shape_class=lambda *a, **k: bp,
                tags=("runtime",),
            ),
            replace=True,
        )
        self.op = AutotunedOp(
            spec,
            db=self.db,
            tune=False,
            warm=False,
            monitor=False,  # the loop times steps itself and feeds the selector
            tolerance=loop_cfg.straggler_tolerance,
        )
        self.bp = bp
        self._state = self.op.select({"n_micro": loop_cfg.n_microbatches})
        self.region = self._state.region
        self.joint_result: Optional[ProgramResult] = None
        self._warmed: set = set()  # microbatch degrees warmed

    # -- whole-program joint AT -------------------------------------------------

    def train_program(self, params, opt_state, batch,
                      trial: Optional[Callable[[int, str], ContextManager]] = None
                      ) -> ProgramSpec:
        """The train step as a joint tuning problem: micro × remat.

        ``micro`` is the live train region (the joint winner hot-applies
        straight through ``region.select``); ``remat`` is the directive
        member.  Each assignment's cost is one full step measured end to
        end on the live state, which the step leaves as it was.  Each of
        those steps runs inside ``trial(n_micro, remat)`` where one is given
        (a caller reading what a step costs beside its time: memory,
        kernel launches)."""
        cfg, opt_cfg, loop = self.cfg, self.opt_cfg, self.loop
        remats = tuple(loop.remat_candidates)
        remat_region = ATRegion(
            "train_remat",
            ParamSpace([PerfParam("remat", remats)]),
            instantiate=lambda pt: make_train_step(
                cfg.with_(remat=pt["remat"]), opt_cfg, loop.n_microbatches),
        )
        if cfg.remat in remats:
            remat_region.select({"remat": cfg.remat})  # untuned baseline
        members = [
            ProgramMember("micro", self.region, bp=self.bp),
            ProgramMember(
                "remat", remat_region,
                bp=BasicParams.make(arch=cfg.name, kind="train_remat", remat=remats,
                                    backend=self.device.type, framework="torch"),
            ),
        ]

        def build(assignment):
            n, remat = int(assignment["micro"]["n_micro"]), assignment["remat"]["remat"]
            step = make_train_step(cfg.with_(remat=remat), opt_cfg, n)

            def thunk():
                with trial(n, remat) if trial is not None else contextlib.nullcontext():
                    _, _, metrics = step(params, opt_state, batch)
                return metrics["loss"]

            return thunk

        tokens = batch.get("tokens")
        extra = {
            "arch": cfg.name,
            "backend": self.device.type,
            "framework": "torch",
            "batch": int(tokens.shape[0]) if tokens is not None else 0,
            "seq": int(tokens.shape[1]) if tokens is not None else 0,
        }
        if loop.device_key:  # device-namespaced program fingerprint
            from ..fleet.fingerprint import device_bp_entries

            extra.update(device_bp_entries(self.device))
        return ProgramSpec(
            f"train_step/{cfg.name}", members, db=self.db, build=build,
            on_apply=self._on_joint_apply, extra=extra,
        )

    def _on_joint_apply(self, assignment) -> None:
        """Mirror the joint winner's remat directive into the live step: the
        micro member *is* the live region, so its ``select`` already landed;
        the remat directive lives in the instantiate closure, so adopting it
        drops the region's built candidates."""
        remat = assignment.get("remat", {}).get("remat")
        if remat is not None and remat != self._step_remat:
            self._step_remat = remat
            self.region.invalidate()

    def joint_tune(self, dataset, force: bool = False,
                   state: Optional[Tuple[Any, Any]] = None,
                   trial: Optional[Callable[[int, str], ContextManager]] = None
                   ) -> ProgramResult:
        """Joint before-execution AT of the whole train step.

        A final winner recorded under the program fingerprint short-circuits
        to a hot apply (zero evaluations); otherwise the joint search
        measures full steps, after one warm step.  ``state`` reuses an
        initialized ``(params, opt_state)`` pair; ``trial`` is as
        :meth:`train_program` takes it."""
        batch = batch_tensors(dataset.batch(0), self.device)
        params, opt_state = state if state is not None else self.init_state()
        program = self.train_program(params, opt_state, batch, trial)
        with serving(self.rule):
            if force or self.db.tuned_point(program.fingerprint()) is None:
                self.warm(params, opt_state, batch, self.loop.microbatch_candidates)
            self.joint_result = program.tune(
                k=self.loop.joint_k, cap=self.loop.joint_cap, force=force
            )
        return self.joint_result

    def warm(self, params, opt_state, batch, degrees: Sequence[int] = ()) -> None:
        """One untimed step on ``batch`` (its result dropped) at each
        microbatch degree in ``degrees`` that splits the batch (the selected
        one if none is named): the kernel shape classes a step reaches
        depend on the microbatch's rows, not on remat, so every class the
        measured steps will meet is tuned or recalled here.  A degree warms
        once a Trainer."""
        rows = int(next(iter(batch.values())).shape[0])
        for n in degrees or (self.region.selected["n_micro"],):
            if n in self._warmed or (n > 1 and rows % n):
                continue
            with serving(self.rule):
                make_train_step(self.cfg.with_(remat=self._step_remat), self.opt_cfg, n)(
                    params, opt_state, batch)
            _sync(self.device)
            self._warmed.add(n)

    # -- state ------------------------------------------------------------------

    def init_state(self, seed: Optional[int] = None) -> Tuple[Any, Any]:
        """(params, opt_state) from ``seed`` (the loop's by default), the
        parameters in the config's dtype."""
        seed = self.loop.seed if seed is None else seed
        gen = torch.Generator(device=self.device).manual_seed(seed)
        dtype = getattr(torch, self.cfg.dtype)
        params = tree_map(lambda t: t.to(dtype), as_tree(init_params(self.cfg, gen, self.device)))
        return params, adamw_init(params, self.opt_cfg)

    # -- main loop ---------------------------------------------------------------

    def run(
        self,
        dataset,
        seed: Optional[int] = None,
        failure_hook: Optional[Callable[[int], None]] = None,
        max_restarts: int = 3,
    ) -> Dict[str, List[float]]:
        params, opt_state = self.init_state(seed)
        if self.loop.joint_tune and self.joint_result is None:
            self.joint_tune(dataset, state=(params, opt_state))
        start = 0
        if self.ckpt is not None:
            restored = self.ckpt.restore_latest({"p": params, "o": opt_state})
            if restored is not None:
                start, tree = restored
                params, opt_state = tree["p"], tree["o"]
        if start < self.loop.total_steps:
            self.warm(params, opt_state, batch_tensors(dataset.batch(start), self.device))

        selector = self._state.selector
        history: Dict[str, List[float]] = {"loss": [], "step_time": [], "step": []}
        step_times: List[float] = []

        step = start
        while step < self.loop.total_steps:
            try:
                if failure_hook is not None:
                    failure_hook(step)
                batch = batch_tensors(dataset.batch(step), self.device)
                t0 = time.perf_counter()
                with serving(self.rule):
                    params, opt_state, metrics = self.region(params, opt_state, batch)
                loss = float(metrics["loss"])  # waits for the step
                dt = time.perf_counter() - t0

                step_times.append(dt)
                if len(step_times) > 32:
                    step_times.pop(0)
                med = float(np.median(step_times))
                if len(step_times) >= 8 and dt > self.loop.straggler_tolerance * med:
                    self.straggler_events += 1
                selector.observe(dt)  # may re-select a degree for the next step

                history["loss"].append(loss)
                history["step_time"].append(dt)
                history["step"].append(step)
                step += 1
                if self.ckpt is not None:
                    self.ckpt.maybe_save(step, {"p": params, "o": opt_state})
            except SimulatedFailure:
                self.restarts += 1
                if self.restarts > max_restarts:
                    raise
                # node loss: restore the latest checkpoint and resume
                params, opt_state = self.init_state(seed)
                step = 0
                if self.ckpt is not None:
                    restored = self.ckpt.restore_latest({"p": params, "o": opt_state})
                    if restored is not None:
                        step, tree = restored
                        params, opt_state = tree["p"], tree["o"]
        if self.ckpt is not None:
            self.ckpt.maybe_save(step, {"p": params, "o": opt_state}, force=True)
        self._final_params = params
        return history
