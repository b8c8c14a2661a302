"""Batched serving loop with traffic-class autotuning.

The port of ``repro.runtime.serve``.  Requests are grouped into fixed-size
batches (prompts left-padded to a shared length), prefilled once, then
decoded step by step.  Both paths are registry ops whose shape class is
extended by a :class:`~repro_torch.core.traffic.TrafficClass` (batch bucket
× sequence bucket × phase) and keyed by the device type and the mesh
(``"host"``: one card, unsharded), so every traffic class tunes on its own.

The candidate family is the serving **degree**: the batch is split into
``degree`` chunks run one after another and re-concatenated.  Rows are
independent in every family except MoE (capacity-bounded dispatch couples
the batch, so MoE serves degree 1 only), so every candidate gives the same
greedy tokens.  Degree trades peak activation memory against per-call
launch overhead: the paper's OpenMP thread count per kernel, switched
through the :class:`~repro_torch.core.degree.DegreeController`.

Tuning never runs on the request hot path, inside the model included: the
model calls run inside :func:`repro_torch.models.serving` with this
server's :class:`~repro_torch.models.ServingRule`, so a kernel's new shape
class (a flash call at a new prompt length) runs the kernel's default
point.  Pass a :class:`~repro_torch.runtime.background_tuner.BackgroundTuner`
and unseen classes, serve ops' and kernels' alike, are tuned on its worker
thread while the hot path serves the default, hot-swapping to the winner
when it lands.  ``inline_tune=True`` tunes on the hot path instead (the
latency baseline, counted in :attr:`Server.hot_path_cost_evaluations`);
the default is no tuning at all.

Fleet hooks: ``device_key=True`` namespaces every traffic class (and the
joint program) under the card's
:class:`~repro_torch.fleet.DeviceFingerprint`, so a fleet-shared DB never
hands this server another device's final; ``drift_monitor`` (a
:class:`~repro_torch.fleet.DriftMonitor`) watches the same step times the
run-time selector gets, but for steps a trial overlapped (a window of the
card's timing lock open at any moment of the step), and mirrors its
selections into the DegreeController as tuned winners are.

The decode step is functional, as the JAX one is: a candidate steps a copy
of the cache it is given (the model's decode writes in place), so a
background trial on the captured arguments never touches the live cache.

On the card a bf16 GEMM accumulates in float32 with no reduced-precision
split-K step (:func:`full_precision_reductions`, set when a server is
built), so that batching moves a request's logits as little as it can.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import (
    ATRegion,
    AutotunedOp,
    BasicParams,
    DegreeController,
    KernelSpec,
    ParamSpace,
    PerfParam,
    ProgramMember,
    ProgramResult,
    ProgramSpec,
    TrafficClass,
    TuningDB,
    register_kernel,
)
from ..core.autotuned import OpState
from ..core.cost import TimingLock, timing_lock
from ..data.pipeline import ServingRequest
from ..distributed.sharding import mesh_bp_entries
from ..models import ServingRule, cache_batch_axis, decode_fn, prefill_fn, serving
from ..models.config import ModelConfig
from .background_tuner import BackgroundTuner


def params_device(params: Any) -> torch.device:
    """The device the model's parameters live on."""
    return next(params.parameters()).device


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (``block_until_ready``), so a
    timed region times the device work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def full_precision_reductions(device: torch.device) -> None:
    """Accumulate bf16 GEMMs in float32 all the way, with no reduced-precision
    split-K step (on CUDA; a process-wide cuBLAS setting, left so).  A batch
    of rows and one row then differ only by the GEMM's own blocking, so a
    request's greedy tokens depend on its batch-mates as little as cuBLAS
    allows: the Server and the engine set it when they are built."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """The greedy next token of each row, (B,) int32."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


@dataclass
class ServeStats:
    prefill_s: float = 0.0
    decode_s: float = 0.0
    tokens_out: int = 0
    # calls of the underlying prefill/decode (a degree-d chunked candidate
    # counts d): the witness that the loop runs exactly the decodes it needs
    prefill_calls: int = 0
    decode_calls: int = 0
    batch_latencies: List[float] = field(default_factory=list)

    @property
    def decode_tok_per_s(self) -> float:
        return self.tokens_out / self.decode_s if self.decode_s else 0.0

    def latency_percentile(self, q: float) -> float:
        """q-th percentile of per-batch wall time (seconds); 0 when empty."""
        if not self.batch_latencies:
            return 0.0
        return float(np.percentile(np.asarray(self.batch_latencies), q))


# Which axis of each model input carries the batch (positions is (3, B, L):
# axis 1).  Cache leaves go through models.cache_batch_axis; an int "len"
# is shared by every chunk.
_BATCH_AXIS = {"tokens": 0, "vision_embeds": 0, "frames": 0, "positions": 1}


def _slice_axis(x: torch.Tensor, axis: int, i: int, n: int) -> torch.Tensor:
    if x.shape[axis] % n:
        raise ValueError(
            f"cannot split axis {axis} of shape {tuple(x.shape)} into {n} "
            f"equal chunks ({x.shape[axis]} % {n} != 0)"
        )
    size = x.shape[axis] // n
    return x.narrow(axis, i * size, size)


def _batch_chunk(batch: Dict[str, Any], i: int, n: int) -> Dict[str, Any]:
    return {k: _slice_axis(v, _BATCH_AXIS.get(k, 0), i, n) for k, v in batch.items()}


def _cache_chunk(cache: Dict[str, Any], i: int, n: int) -> Dict[str, Any]:
    out = {}
    for k, v in cache.items():
        ax = cache_batch_axis(k, getattr(v, "ndim", 0))
        out[k] = v if ax is None else _slice_axis(v, ax, i, n)
    return out


def _cache_concat(chunks: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    out = {}
    for k, v in chunks[0].items():
        ax = cache_batch_axis(k, getattr(v, "ndim", 0))
        out[k] = v if ax is None else torch.cat([c[k] for c in chunks], dim=ax)
    return out


def copy_cache(cache: Dict[str, Any]) -> Dict[str, Any]:
    """A cache whose tensors are copies: the model's decode writes in place."""
    return {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in cache.items()}


def check_unique_rids(requests: Sequence[ServingRequest]) -> None:
    """Duplicate rids would silently overwrite each other in the rid-keyed
    result dict; fail fast instead (shared by Server and StreamingEngine)."""
    seen: set = set()
    for r in requests:
        if r.rid in seen:
            raise ValueError(f"duplicate request rid {r.rid!r} in trace")
        seen.add(r.rid)


def check_well_formed(requests: Sequence[ServingRequest]) -> None:
    """The static server's strict contract: a malformed request is a caller
    bug and fails fast with a named reason instead of a shape error deep in
    a prefill.  (The hardened StreamingEngine instead absorbs these
    per request with an ``error`` retirement.)"""
    for r in requests:
        if len(r.prompt) < 1:
            raise ValueError(f"request {r.rid}: empty prompt")
        if r.max_new_tokens < 1:
            raise ValueError(
                f"request {r.rid}: max_new_tokens must be >= 1, "
                f"got {r.max_new_tokens}"
            )


def build_batch_inputs(
    cfg: ModelConfig, group: Sequence[ServingRequest], plen: int, device: Any,
) -> Dict[str, Any]:
    """Model inputs for one prefill group on ``device``, prompts left-padded
    to ``plen`` with token 0 and no mask, as the JAX package builds them."""
    B = len(group)
    toks = np.zeros((B, plen), np.int32)
    for i, r in enumerate(group):
        toks[i, -len(r.prompt):] = r.prompt[:plen]
    batch: Dict[str, Any] = {"tokens": torch.from_numpy(toks).to(device)}
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.zeros(
            (B, cfg.n_vision_tokens, cfg.d_model), dtype=torch.bfloat16, device=device)
        pos = torch.arange(plen, dtype=torch.int32, device=device).expand(B, plen)
        batch["positions"] = pos.expand(3, B, plen)
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.zeros(
            (B, cfg.encoder_len, cfg.d_model), dtype=torch.bfloat16, device=device)
    return batch


def decode_inputs(cfg: ModelConfig, tok: torch.Tensor, length: Any) -> Dict[str, Any]:
    """One decode step's inputs for the just-sampled tokens ``tok`` (B,):
    the VLM also gets its M-RoPE positions, each row's ``length`` (an int
    shared by the rows, or a (B,) tensor) on all three streams."""
    d: Dict[str, Any] = {"tokens": tok[:, None]}
    if cfg.family == "vlm":
        B = tok.shape[0]
        if isinstance(length, torch.Tensor):
            pos = length.to(device=tok.device, dtype=torch.int32).reshape(B, 1)
        else:
            pos = torch.full((B, 1), int(length), dtype=torch.int32, device=tok.device)
        d["positions"] = pos.expand(3, B, 1)
    return d


class Server:
    def __init__(
        self,
        cfg: ModelConfig,
        params: Any,
        batch_size: int = 4,
        max_len: int = 128,
        tuning_db: Optional[TuningDB] = None,
        background_tuner: Optional[BackgroundTuner] = None,
        inline_tune: bool = False,
        device_key: bool = False,
        drift_monitor: Optional[Any] = None,
        mesh: Any = None,
    ) -> None:
        self.cfg = cfg
        self.params = params
        # the mesh the BP keys name (``mesh_bp_entries``): None is one card,
        # "host", unless an ``activation_sharding`` context names one
        self.mesh = mesh
        self.device = params_device(params)
        full_precision_reductions(self.device)
        self.batch_size = batch_size
        self.max_len = max_len
        self.db = tuning_db or TuningDB()
        self.background = background_tuner
        self.inline_tune = inline_tune
        self.device_key = device_key
        self.drift = drift_monitor
        if self.drift is not None and self.drift.on_apply is None:
            self.drift.on_apply = self._on_tuned
        self._prefilled: set = set()  # prefill classes called once (``_called_before``)
        # how the model's kernel calls resolve inside every serve call
        self.rule = ServingRule(self.db, background_tuner, inline_tune)
        self.degree = DegreeController(max_degree=batch_size)
        self.stats = ServeStats()
        rule = self.rule

        # capacity=max_len gives decode real KV headroom (a cache born full
        # would clamp every decode write onto the last prompt slot)
        def counted_prefill(p, b):
            self.stats.prefill_calls += 1
            with serving(rule):
                return prefill_fn(p, b, cfg, capacity=max(max_len, b["tokens"].shape[1]))

        def counted_decode(p, b, c):
            self.stats.decode_calls += 1
            with serving(rule):
                return decode_fn(p, b, copy_cache(c), cfg)

        self._prefill = counted_prefill
        self._decode = counted_decode
        self.prefill_op = self._make_prefill_op()
        self.decode_op = self._make_decode_op()
        self._hot_tuned: set = set()  # fingerprints tuned inline on a serve call
        self.joint_result: Optional[ProgramResult] = None

    # -- degree candidate family -----------------------------------------------

    def _degree_domain(self) -> Tuple[int, ...]:
        """Serving degrees: batch-chunk counts that keep outputs identical.

        MoE capacity-bounded dispatch couples rows across the batch (which
        tokens drop depends on the whole group), so MoE only ever serves the
        whole batch at once.
        """
        if self.cfg.family == "moe":
            return (1,)
        return tuple(
            d for d in (1, 2, 4) if d <= self.batch_size and self.batch_size % d == 0
        )

    def _degree_space(self) -> ParamSpace:
        return ParamSpace([PerfParam("degree", self._degree_domain())])

    def _bp(self, kernel: str) -> BasicParams:
        # the exact serving batch (not just the traffic bucket) is part of
        # the key: the degree domain is "divisors of batch_size", so two
        # servers whose batch sizes share a pow2 bucket must not share a
        # tuned winner
        return BasicParams.make(
            kernel=kernel, arch=self.cfg.name, batch=self.batch_size,
            backend=self.device.type, **mesh_bp_entries(self.mesh),
        )

    # -- registry ops ----------------------------------------------------------

    def _make_prefill_op(self) -> AutotunedOp:
        cfg, prefill = self.cfg, self._prefill

        def instantiate(point):
            d = int(point.get("degree", 1))
            if d == 1:
                return lambda params, batch: prefill(params, batch)

            def chunked(params, batch):
                outs = [prefill(params, _batch_chunk(batch, i, d)) for i in range(d)]
                logits = torch.cat([o[0] for o in outs], dim=0)
                return logits, _cache_concat([o[1] for o in outs])

            return chunked

        def traffic_class(params, batch) -> TrafficClass:
            B, plen = batch["tokens"].shape
            return TrafficClass.of("prefill", int(B), int(plen))

        spec = register_kernel(
            KernelSpec(
                name=f"serve_prefill/{cfg.name}",
                make_region=lambda bp: ATRegion("serve_prefill", self._degree_space(),
                                                instantiate),
                shape_class=lambda params, batch: self._bp("serve_prefill"),
                tags=("runtime", "serve"),
                traffic_class=traffic_class,
            ),
            replace=True,
        )
        return AutotunedOp(spec, db=self.db, tune=self.inline_tune, warm=False, monitor=False,
                           device_key=self.device_key)

    def _make_decode_op(self) -> AutotunedOp:
        cfg, decode = self.cfg, self._decode

        def instantiate(point):
            d = int(point.get("degree", 1))
            if d == 1:
                return lambda params, batch, cache: decode(params, batch, cache)

            def chunked(params, batch, cache):
                outs = [
                    decode(params, _batch_chunk(batch, i, d), _cache_chunk(cache, i, d))
                    for i in range(d)
                ]
                logits = torch.cat([o[0] for o in outs], dim=0)
                return logits, _cache_concat([o[1] for o in outs])

            return chunked

        def traffic_class(params, batch, cache) -> TrafficClass:
            # decode classes bucket by context length (the KV len at decode
            # start): chunking economics differ between short- and
            # long-context decode, so they must not share a winner
            return TrafficClass.of(
                "decode", int(batch["tokens"].shape[0]), max(1, int(cache["len"])),
            )

        spec = register_kernel(
            KernelSpec(
                name=f"serve_decode/{cfg.name}",
                make_region=lambda bp: ATRegion("serve_decode", self._degree_space(),
                                                instantiate),
                shape_class=lambda params, batch, cache: self._bp("serve_decode"),
                tags=("runtime", "serve"),
                traffic_class=traffic_class,
            ),
            replace=True,
        )
        return AutotunedOp(spec, db=self.db, tune=self.inline_tune, warm=False, monitor=False,
                           device_key=self.device_key)

    # -- tuning hand-off -------------------------------------------------------

    def _resolve(self, op: AutotunedOp, *args: Any) -> OpState:
        """State for this call's traffic class: background submit or inline."""
        if self.background is not None:
            state = self.background.submit(op, *args, on_complete=self._on_tuned)
        else:
            before = op.states() if self.inline_tune else None
            state = op.resolve(*args)
            # attribution decided synchronously (thread idents recycle): a
            # state this very resolve just tuned was tuned on the serve path
            if (before is not None and state.tuned
                    and state.bp.fingerprint() not in before):
                self._hot_tuned.add(state.bp.fingerprint())
        if state.tuned or state.from_cache:  # winner already known (DB hit /
            self._on_tuned(state)            # inline tune): mirror its degree
        return state

    def _watch_drift(self, lock: TimingLock, mark: tuple) -> bool:
        """Feed the drift watch a step timed since ``mark``?  Not if a trial
        timed on the card at any moment of it: the trial's kernels ran
        beside the step's (one such step read 767.7 ms against the 136.1 ms
        its final was recorded at, alone, on an H100), which the finals,
        each timed in a window of its own, never saw.  Classes queued or
        tuned on the host meanwhile do not hold the watch up."""
        return self.drift is not None and lock.quiet_since(mark)

    def _called_before(self, state: OpState) -> bool:
        """True from the second prefill of ``state``'s class in this
        process.  The first one pays what a process pays once (the kernels'
        modules loaded, the class's shapes met for the first time): on an
        H100 a recall run's first prefill of the 32-token class read 0.332
        s against the 0.112 s its final was recorded at, and the watch
        demoted a healthy final.  A decode group feeds the watch its steps'
        median, which one step does not move."""
        key = id(state)
        if key in self._prefilled:
            return True
        self._prefilled.add(key)
        return False

    def _on_tuned(self, state: OpState) -> None:
        """Mirror the live selection's degree into the DegreeController so
        the serve loop's region entries switch to it (and restore max on
        exit).  Called when a winner lands (background or inline/DB) and
        again after a RuntimeSelector demotion re-selects."""
        deg = state.region.selected.get("degree")
        if deg is not None and state.traffic is not None:
            self.degree.set_tuned(state.traffic.label, int(deg))

    @property
    def hot_path_cost_evaluations(self) -> int:
        """Tuning cost evaluations paid inside a :meth:`run` call, by the
        serve ops and by the kernels the model calls.

        The acceptance bar for background tuning: stays 0 — every evaluation
        happens on the BackgroundTuner's worker thread.
        """
        total = self.rule.hot_path_cost_evaluations
        for op in (self.prefill_op, self.decode_op):
            for st in op.states().values():
                if st.bp.fingerprint() in self._hot_tuned:
                    total += st.cost_evaluations
        return total

    @property
    def traffic_classes_seen(self) -> List[str]:
        labels = set()
        for op in (self.prefill_op, self.decode_op):
            for st in op.states().values():
                if st.traffic is not None:
                    labels.add(st.traffic.label)
        return sorted(labels)

    # -- whole-program joint AT ------------------------------------------------

    def serve_program(
        self, requests: Sequence[ServingRequest], decode_steps: int = 4
    ) -> ProgramSpec:
        """The serve step as a joint problem: prefill degree × decode degree.

        The two phases share the KV-cache layout and the card's memory
        headroom, so their best chunking degrees are coupled: the joint
        cost is one *full* serve step (prefill + ``decode_steps`` decodes)
        measured end to end, and the winner hot-applies through each
        region's ``select`` plus the DegreeController mirror.
        """
        group = list(requests[: self.batch_size])
        if not group:
            raise ValueError("serve_program needs at least one request")
        while len(group) < self.batch_size:
            group.append(group[-1])
        plen = max(len(r.prompt) for r in group)
        batch = self._batch_inputs(group, plen)
        params, cfg = self.params, self.cfg
        pstate = self.prefill_op.resolve_deferred(params, batch)
        logits, cache = pstate.region(params, batch)
        tok0 = greedy(logits)
        dstate = self.decode_op.resolve_deferred(
            params, decode_inputs(cfg, tok0, cache["len"]), cache
        )
        members = [
            ProgramMember("prefill", pstate.region, bp=pstate.bp),
            ProgramMember("decode", dstate.region, bp=dstate.bp),
        ]

        def build(assignment):
            pfn = pstate.region.candidate(assignment["prefill"])
            dfn = dstate.region.candidate(assignment["decode"])

            def thunk():
                lg, ca = pfn(params, batch)
                tok = greedy(lg)
                for _ in range(decode_steps):
                    lg, ca = dfn(params, decode_inputs(cfg, tok, ca["len"]), ca)
                    tok = greedy(lg)
                return lg

            return thunk

        def on_apply(assignment):
            # winners land in the DegreeController exactly like per-phase
            # tuning results do, so run()'s set/restore bracket adopts them
            self._on_tuned(pstate)
            self._on_tuned(dstate)

        device_extra = {}
        if self.device_key:
            # a joint winner measured on one device must not be recalled on
            # another, like every other DB key of this server
            from ..fleet.fingerprint import device_bp_entries

            device_extra = device_bp_entries(self.device)
        return ProgramSpec(
            f"serve_step/{cfg.name}", members, db=self.db, build=build,
            on_apply=on_apply,
            extra={
                "batch": self.batch_size, "plen": int(plen),
                "steps": int(decode_steps), "backend": self.device.type,
                **mesh_bp_entries(self.mesh), **device_extra,
            },
        )

    def joint_tune(
        self,
        requests: Sequence[ServingRequest],
        decode_steps: int = 4,
        cap: Optional[int] = 16,
        k: Optional[int] = None,
        force: bool = False,
    ) -> ProgramResult:
        """Joint before-execution AT of one full serve step."""
        program = self.serve_program(requests, decode_steps=decode_steps)
        self.joint_result = program.tune(k=k, cap=cap, force=force)
        return self.joint_result

    # -- batching --------------------------------------------------------------

    def _batch_inputs(self, group: Sequence[ServingRequest], plen: int) -> Dict[str, Any]:
        return build_batch_inputs(self.cfg, group, plen, self.device)

    def run(self, requests: Sequence[ServingRequest]) -> Dict[int, List[int]]:
        """Greedy-decode every request; returns rid -> generated token ids."""
        check_unique_rids(requests)
        check_well_formed(requests)
        out: Dict[int, List[int]] = {}
        cfg, device = self.cfg, self.device
        lock = timing_lock(device)
        for i in range(0, len(requests), self.batch_size):
            real = list(requests[i: i + self.batch_size])
            group = list(real)
            while len(group) < self.batch_size:  # pad the tail batch
                group.append(group[-1])
            plen = max(len(r.prompt) for r in group)
            batch = self._batch_inputs(group, plen)

            t_batch = time.perf_counter()
            pstate = self._resolve(self.prefill_op, self.params, batch)
            plabel = pstate.traffic.label if pstate.traffic else "prefill"
            mark = lock.mark()
            t0 = time.perf_counter()
            with self.degree.region(plabel):
                # dispatch through the resolved region directly: re-resolving
                # per call would recompute the BP fingerprint on the hot path
                logits, cache = pstate.region(self.params, batch)
                sync(device)
            prefill_elapsed = time.perf_counter() - t0
            self.stats.prefill_s += prefill_elapsed
            if pstate.selector is not None:
                # run-time layer: one observation per region call, so a
                # regressed winner demotes to the next-best precompiled one
                if pstate.selector.observe(prefill_elapsed):
                    self._on_tuned(pstate)  # keep the controller in sync
            if self._called_before(pstate) and self._watch_drift(lock, mark):
                # the drift watch rides the same observation; the call args
                # are captured so a scheduled re-tune measures candidates on
                # a real batch
                self.drift.observe(self.prefill_op, pstate, prefill_elapsed,
                                   (self.params, batch))

            n_steps = max(r.max_new_tokens for r in group)
            gen: List[List[int]] = [[] for _ in group]
            t0 = time.perf_counter()
            # the prefill's argmax IS generated token #1: only n_steps - 1
            # decode calls remain
            next_tok = greedy(logits)
            for gi, t in enumerate(next_tok.tolist()):
                gen[gi].append(t)

            if n_steps > 1:
                dbatch = decode_inputs(cfg, next_tok, cache["len"])
                dstate = self._resolve(self.decode_op, self.params, dbatch, cache)
                dlabel = dstate.traffic.label if dstate.traffic else "decode"
                step_times: List[float] = []
                quiet_times: List[float] = []  # those no trial overlapped
                # one set/restore per group, not per token: the label (and
                # the executed candidate) is fixed for the whole decode loop
                with self.degree.region(dlabel):
                    for _ in range(n_steps - 1):
                        mark = lock.mark()
                        ts = time.perf_counter()
                        logits, cache = dstate.region(self.params, dbatch, cache)
                        sync(device)
                        step_times.append(time.perf_counter() - ts)
                        if self._watch_drift(lock, mark):
                            quiet_times.append(step_times[-1])
                        next_tok = greedy(logits)
                        for gi, t in enumerate(next_tok.tolist()):
                            gen[gi].append(t)
                        dbatch = decode_inputs(cfg, next_tok, cache["len"])
                if dstate.selector is not None and step_times:
                    # unit-compatible with the tuned per-call trial cost:
                    # median of the bare region-call times, one DB
                    # observation per group, never per token
                    if dstate.selector.observe(float(np.median(step_times))):
                        self._on_tuned(dstate)  # keep the controller in sync
                if quiet_times:
                    self.drift.observe(self.decode_op, dstate, float(np.median(quiet_times)),
                                       (self.params, dbatch, cache))
            self.stats.decode_s += time.perf_counter() - t0
            # only tokens delivered to real requests count: padded tail rows
            # and steps past a request's own max_new_tokens are not output
            self.stats.tokens_out += sum(min(r.max_new_tokens, n_steps) for r in real)
            self.stats.batch_latencies.append(time.perf_counter() - t_batch)

            for gi, r in enumerate(real):
                out[r.rid] = gen[gi][: r.max_new_tokens]
        return out
