"""Continuous-batching streaming engine.

The port of ``repro.runtime.engine``.  :class:`~repro_torch.runtime.serve.Server`
batches a request *list*: compose a fixed-size group, prefill it once,
decode every row to the group's max.  This module replaces that with the
engine shape production LLM servers converged on (Orca-style
iteration-level scheduling, vLLM-style paged KV):

* an **admission queue** consumes :class:`~repro_torch.data.pipeline.ServingRequest`
  with open-loop ``arrival_s`` timestamps (``bursty_open_loop_trace``);
* an **iteration-level scheduler** composes every step from interleaved
  prefill and decode work and retires a finished request *that step*;
* a **paged KV cache**: a block pool with a free-list
  :class:`BlockAllocator` and a ``block_table`` (rid → block).  Blocks are
  sequence-granular (one block holds one request's whole KV row at fixed
  capacity), so decode batches compose by *index gather/scatter* into the
  pool.

Prefill groups and decode gathers dispatch through registry ops
(``engine_prefill`` / ``engine_decode``) whose candidate family is the
chunking **degree**, bracketed by the
:class:`~repro_torch.core.degree.DegreeController`.  The scheduler itself is
a tuned kernel (``serve_scheduler``): prefill chunk size, prefill/decode
interleave, admission policy, max in-flight and (when the queue is bounded)
the shed policy form a :class:`~repro_torch.core.params.ParamSpace` keyed per
:class:`~repro_torch.core.traffic.TrafficClass` of the *queue state* (phase
``stream``), searched off the hot path by the
:class:`~repro_torch.runtime.background_tuner.BackgroundTuner` with a
measured shadow replay as the cost.

Decode composes heterogeneous positions in one batched step: the pool is
the model's own cache at batch ``n_blocks`` with a per-row ``len`` (a
``(n_blocks,)`` tensor), a step gathers its rows (index copies), decodes
them at their own positions (:func:`repro_torch.models.decode_fn` takes a
per-row ``len``: RoPE position, written slot and valid-key mask per row),
and scatters them back.  The JAX engine gets the same by ``jax.vmap`` of
the batch-1 decode; unwritten slots are masked, so extra pool capacity is
numerically inert.  MoE decode rows dispatch as groups of one token each
(``moe_groups`` = rows), which is the batch-1 dispatch of every row; MoE
prefill groups pin to one request, as in JAX.

The model's decode writes its cache in place, where the JAX step is
functional ("the pool only swaps on success").  So a step decodes gathered
*copies* of the rows and the engine scatters them into the pool only after
the step returned; a prefilled group is inserted the same way.  A step
that raises leaves the pool unchanged, and the one-row-at-a-time retry of
fault isolation starts from the same state.  Decode rows are padded to a
power-of-two bucket by replicating row 0 (the shape classes stay per
bucket), and only the first ``A`` real rows are scattered back, so no
duplicate index reaches ``index_copy_``.

**Hardening** (the default, ``hardened=True``): no input trace, resource
state, or per-request failure crashes or wedges the engine; every request
retires exactly once with a :class:`RequestResult` status in
``{ok, timed_out, shed, error}``:

* **deadlines** — a request past its ``deadline_s`` (or the engine-level
  ``default_ttl_s``) retires ``timed_out``, queued or in flight;
* **preemption with recompute** — when the pool is exhausted and a strictly
  higher-priority admission is blocked, the lowest-priority in-flight
  request is evicted and requeued with its generated tokens as *replay*
  state, so its final output equals the uninterrupted run's;
  ``max_preemptions`` bounds re-eviction (anti-livelock);
* **load shedding** — with ``queue_limit`` set, the queue is bounded by a
  shed policy (``reject-new`` | ``drop-oldest`` | ``deadline-aware``) that
  joins the tuned scheduler knobs;
* **fault isolation** — a prefill/decode step that raises is retried one
  request at a time; a request that still raises retires ``error``; a
  watchdog raises :class:`EngineStalled` with a state dump after
  ``watchdog_limit`` iterations without progress;
* **chaos** — :class:`~repro_torch.runtime.chaos.ChaosInjector` hooks, called
  in the JAX engine's order, make every path above a deterministic test.

``hardened=False`` restores the pre-hardening contract (validation errors
and step faults raise to the caller).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

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
    TrafficClass,
    TuningDB,
    bucket_pow2,
    register_kernel,
)
from ..core.autotuned import OpState
from ..data.pipeline import ServingRequest
from ..models import (
    ServingRule, cache_batch_axis, decode_fn, init_cache, prefill_fn, serving,
)
from ..models.config import ModelConfig
from ..obs.trace import current_tracer
from ..distributed.sharding import mesh_bp_entries
from .background_tuner import BackgroundTuner
from .serve import (
    _batch_chunk,
    _cache_concat,
    build_batch_inputs,
    check_unique_rids,
    decode_inputs,
    full_precision_reductions,
    greedy,
    params_device,
    sync,
)


# ---------------------------------------------------------------------------
# Typed engine failures
# ---------------------------------------------------------------------------


class KVPoolExhausted(RuntimeError):
    """The block pool has no free block.

    Subclasses ``RuntimeError`` so pre-hardening callers (and tests) that
    catch the bare exhaustion error keep working; carries the pool stats the
    scheduler needs to decide between waiting, shedding, and preempting.
    """

    def __init__(self, n_blocks: int, in_use: int) -> None:
        super().__init__(
            f"KV block pool exhausted ({in_use}/{n_blocks} blocks in use); "
            "the scheduler must bound admissions by allocator.free"
        )
        self.n_blocks = int(n_blocks)
        self.in_use = int(in_use)

    @property
    def free(self) -> int:
        return self.n_blocks - self.in_use


class EngineStalled(RuntimeError):
    """Watchdog: no retire/admit/decode progress for ``watchdog_limit``
    consecutive scheduler iterations — fail loudly with a state dump
    instead of spinning forever."""


# ---------------------------------------------------------------------------
# Paged KV cache
# ---------------------------------------------------------------------------


class BlockAllocator:
    """Free-list allocator over a fixed pool of KV blocks."""

    def __init__(self, n_blocks: int) -> None:
        if n_blocks < 1:
            raise ValueError("n_blocks must be >= 1")
        self.n_blocks = int(n_blocks)
        self._free: List[int] = list(range(n_blocks - 1, -1, -1))
        self.peak_in_use = 0

    @property
    def free(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.n_blocks - len(self._free)

    def allocate(self) -> int:
        if not self._free:
            raise KVPoolExhausted(self.n_blocks, self.in_use)
        block = self._free.pop()
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return block

    def release(self, block: int) -> None:
        # the allocator stays strict (double-free of a *block* is always a
        # bookkeeping bug); rid-level idempotence lives in PagedKVCache
        if not (0 <= block < self.n_blocks) or block in self._free:
            raise ValueError(f"release of invalid or free block {block}")
        self._free.append(block)


class PagedKVCache:
    """A block pool of per-request KV rows plus the rid → block table.

    The pool is the model's own decode cache at batch ``n_blocks`` and the
    fixed ``capacity``, its ``len`` a ``(n_blocks,)`` tensor so each block
    carries its own position.  :meth:`insert` scatters prefilled rows into
    allocated blocks; decode gathers rows by block index (copies), steps
    them, and :meth:`scatter` writes them back.
    """

    def __init__(self, cfg: ModelConfig, n_blocks: int, capacity: int,
                 device: Any = "cuda") -> None:
        self.cfg = cfg
        self.capacity = int(capacity)
        self.device = torch.device(device)
        self.allocator = BlockAllocator(n_blocks)
        self.block_table: Dict[int, int] = {}
        self.pool: Dict[str, Any] = init_cache(cfg, n_blocks, self.capacity, self.device)
        self.pool["len"] = torch.zeros(n_blocks, dtype=torch.int64, device=self.device)

    @property
    def n_blocks(self) -> int:
        return self.allocator.n_blocks

    @property
    def free(self) -> int:
        return self.allocator.free

    def allocate(self, rid: int) -> int:
        if rid in self.block_table:
            raise ValueError(f"rid {rid} already holds block {self.block_table[rid]}")
        block = self.allocator.allocate()
        self.block_table[rid] = block
        return block

    def release(self, rid: int) -> None:
        """Release ``rid``'s block.  Idempotent: releasing a rid that holds
        no block is a no-op, so every retirement path (finish, timeout,
        shed, error, preempt) can release unconditionally without tracking
        who already did."""
        block = self.block_table.pop(rid, None)
        if block is not None:
            self.allocator.release(block)

    def block_of(self, rid: int) -> int:
        return self.block_table[rid]

    def insert(self, rids: Sequence[int], cache: Dict[str, Any]) -> None:
        """Scatter the rows of a freshly prefilled group cache into blocks.

        ``cache`` has batch ``len(rids)`` and this pool's exact capacity;
        row ``i`` lands in ``rids[i]``'s allocated block.
        """
        slots = torch.tensor([self.block_table[r] for r in rids], dtype=torch.int64,
                             device=self.device)
        _insert_rows(self.pool, cache, slots)

    def scatter(self, idx: torch.Tensor, rows: Dict[str, Any], n: int) -> None:
        """The first ``n`` rows of ``rows`` back into blocks ``idx[:n]``."""
        _insert_rows(self.pool, _take_rows(rows, torch.arange(n, device=idx.device)),
                     idx[:n])


def _insert_rows(pool: Dict[str, Any], cache: Dict[str, Any], slots: torch.Tensor) -> None:
    """pool[slots[i]] <- row i of the batched cache (per leaf), in place."""
    for k, v in pool.items():
        if k == "len":
            v[slots] = torch.as_tensor(cache["len"], dtype=v.dtype, device=v.device)
            continue
        ax = cache_batch_axis(k, v.ndim)
        v.index_copy_(ax, slots, cache[k].to(v.dtype))


# ---------------------------------------------------------------------------
# Engine stats
# ---------------------------------------------------------------------------


@dataclass
class StreamStats:
    tokens_out: int = 0          # tokens delivered to real requests, only
    prefill_steps: int = 0       # scheduler iterations that ran a prefill
    decode_steps: int = 0        # scheduler iterations' decode micro-steps
    prefill_calls: int = 0       # underlying jitted prefill invocations
    decode_calls: int = 0        # underlying jitted gather-step invocations
    prefill_s: float = 0.0
    decode_s: float = 0.0
    idle_s: float = 0.0          # virtual-clock time with nothing runnable
    makespan_s: float = 0.0      # arrival of first request -> last retire
    peak_in_flight: int = 0
    ttft_s: Dict[int, float] = field(default_factory=dict)
    finish_s: Dict[int, float] = field(default_factory=dict)
    # hardening counters (all zero on a clean trace)
    timeouts: int = 0            # requests retired past deadline
    sheds: int = 0               # requests shed by admission control
    errors: int = 0              # requests retired by fault isolation
    duplicates: int = 0          # duplicate-rid arrivals ignored
    preempted: int = 0           # KV-block evictions for priority admissions
    step_faults: int = 0         # prefill/decode steps that raised
    knob_faults: int = 0         # scheduler-knob resolutions that raised

    @property
    def tok_per_s(self) -> float:
        return self.tokens_out / self.makespan_s if self.makespan_s else 0.0

    def ttft_percentile(self, q: float) -> float:
        if not self.ttft_s:
            return 0.0
        return float(np.percentile(np.asarray(list(self.ttft_s.values())), q))

    def as_metrics(self) -> Dict[str, float]:
        """Flat numeric snapshot for the metrics registry
        (:func:`repro_torch.obs.metrics.snapshot_stats` protocol)."""
        return {
            "tokens_out": self.tokens_out,
            "prefill_steps": self.prefill_steps,
            "decode_steps": self.decode_steps,
            "prefill_calls": self.prefill_calls,
            "decode_calls": self.decode_calls,
            "prefill_s": self.prefill_s,
            "decode_s": self.decode_s,
            "idle_s": self.idle_s,
            "makespan_s": self.makespan_s,
            "peak_in_flight": self.peak_in_flight,
            "requests_finished": len(self.finish_s),
            "timeouts": self.timeouts,
            "sheds": self.sheds,
            "errors": self.errors,
            "duplicates": self.duplicates,
            "preempted": self.preempted,
            "step_faults": self.step_faults,
            "knob_faults": self.knob_faults,
            "tok_per_s": self.tok_per_s,
            "ttft_p50_s": self.ttft_percentile(50),
            "ttft_p99_s": self.ttft_percentile(99),
        }


@dataclass
class RequestResult:
    """Terminal record of one request — exactly one per admitted rid."""

    rid: int
    status: str  # "ok" | "timed_out" | "shed" | "error"
    tokens: List[int] = field(default_factory=list)  # delivered (may be partial)
    detail: str = ""


#: terminal statuses a request can retire with (the property-test alphabet)
REQUEST_STATUSES = ("ok", "timed_out", "shed", "error")


@dataclass
class _Waiting:
    """One queued request plus its hardening state."""

    req: ServingRequest
    # tokens already delivered before a preemption: on re-admission they
    # force the decode trajectory (recompute), so output stays bit-identical
    resume: List[int] = field(default_factory=list)
    preemptions: int = 0
    deadline: Optional[float] = None  # absolute virtual-clock deadline


@dataclass
class _Active:
    """One in-flight request: its block, generated tokens, current context."""

    req: ServingRequest
    block: int
    gen: List[int]
    last_tok: int
    ctx: int  # tokens currently in the row's KV (plen + decodes done)
    replay: List[int] = field(default_factory=list)  # forced recompute tokens
    preemptions: int = 0
    deadline: Optional[float] = None


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

# scheduler-knob vocabulary: max requests per prefill group, decode
# micro-steps per scheduler iteration, queue ordering, admission ceiling,
# bounded-queue shed policy
SCHED_KNOBS = (
    "prefill_chunk", "interleave", "admission", "max_in_flight", "shed_policy",
)

#: bounded-queue shed policies (the `shed_policy` knob's full domain)
SHED_POLICIES = ("reject-new", "drop-oldest", "deadline-aware")

# virtual-clock advance per no-progress iteration while the watchdog counts
_STALL_TICK_S = 1e-3
# shadow-replay cost penalty per shed request (keeps "shed everything"
# from looking like a great makespan)
_SHED_COST_S = 0.05


class StreamingEngine:
    """Continuous-batching server over a paged KV pool.

    ``serve(requests)`` replays an open-loop trace on a virtual clock: the
    clock advances by each step's *measured* wall time and jumps over idle
    gaps, so time-to-first-token percentiles are deterministic-shaped and
    CI-safe (no sleeps) while still reflecting real step costs.

    After ``serve`` returns, ``self.results`` maps every admitted rid to its
    :class:`RequestResult`; the return value stays rid → tokens for the
    ``ok`` subset (the pre-hardening contract).
    """

    def __init__(
        self,
        cfg: ModelConfig,
        params: Any,
        n_blocks: int = 8,
        max_len: int = 128,
        tuning_db: Optional[TuningDB] = None,
        background_tuner: Optional[BackgroundTuner] = None,
        inline_tune: bool = False,
        device_key: bool = False,
        hardened: bool = True,
        queue_limit: Optional[int] = None,
        shed_policy: Optional[str] = None,
        default_ttl_s: Optional[float] = None,
        max_preemptions: int = 3,
        watchdog_limit: int = 200,
        chaos: Any = None,
        timer: Any = None,
        tracer: Any = None,
        mesh: Any = None,
    ) -> None:
        if shed_policy is not None and shed_policy not in SHED_POLICIES:
            raise ValueError(
                f"shed_policy must be one of {SHED_POLICIES}, got {shed_policy!r}"
            )
        if queue_limit is not None and queue_limit < 1:
            raise ValueError("queue_limit must be >= 1")
        self.cfg = cfg
        self.params = params
        self.mesh = mesh  # what the BP keys name; None is one card, "host"
        self.device = params_device(params)
        full_precision_reductions(self.device)
        self.max_len = int(max_len)
        self.db = tuning_db or TuningDB()
        self.background = background_tuner
        self.inline_tune = inline_tune
        # namespace every class under the card's DeviceFingerprint, so a
        # fleet-shared DB never hands this engine another device's final
        self.device_key = device_key
        # how the model's kernel calls resolve inside every engine call
        self.rule = ServingRule(self.db, background_tuner, inline_tune)
        self.hardened = bool(hardened)
        self.queue_limit = queue_limit
        self.shed_policy = shed_policy  # pin; None lets the tuner choose
        self.default_ttl_s = default_ttl_s
        self.max_preemptions = int(max_preemptions)
        self.watchdog_limit = int(watchdog_limit)
        self.chaos = chaos
        # observability: ``timer`` is the *measurement* clock (step wall
        # times feeding the virtual clock) — inject e.g. a TickTimer for
        # byte-identical deterministic traces; ``tracer`` pins a Tracer to
        # this engine (falls back to the process-wide current_tracer())
        self._timer = timer if timer is not None else time.perf_counter
        self.tracer = tracer
        self.cache = PagedKVCache(cfg, n_blocks, self.max_len, self.device)
        self.degree = DegreeController(max_degree=max(2, n_blocks))
        self.stats = StreamStats()
        self.results: Dict[int, RequestResult] = {}
        self.duplicate_rids: List[int] = []
        self._delivered: Set[int] = set()
        self._hot_tuned: set = set()

        # raw primitives (shared by hot path, candidates, and the
        # scheduler's shadow replay); counted wrappers feed the stats the
        # regression tests assert on.  capacity is pinned so prefilled group
        # caches always match the pool's row layout.
        cap, rule = self.max_len, self.rule

        def prefill_raw(p, b):
            with serving(rule):
                return prefill_fn(p, b, cfg, capacity=cap)

        self._prefill_raw = prefill_raw
        self._decode_raw = _make_decode_rows(cfg, rule)

        def counted_prefill(p, b):
            self.stats.prefill_calls += 1
            return self._prefill_raw(p, b)

        def counted_decode(p, pool, idx, toks):
            self.stats.decode_calls += 1
            return self._decode_raw(p, pool, idx, toks)

        self._prefill = counted_prefill
        self._decode = counted_decode
        self.prefill_op = self._make_prefill_op()
        self.decode_op = self._make_decode_op()
        self.sched_op = self._make_sched_op()
        # last-resort knobs when the tuning path itself fails (hardened):
        # sequential admission, full pool, no reordering, shed newest
        self._fallback_knobs: Dict[str, Any] = {
            "prefill_chunk": 1,
            "interleave": 1,
            "admission": "fcfs",
            "max_in_flight": self.cache.n_blocks,
            "shed_policy": self.shed_policy or "reject-new",
        }

    def _tr(self):
        """Active tracer for engine events (pinned beats process-global)."""
        return self.tracer if self.tracer is not None else current_tracer()

    # -- registry ops --------------------------------------------------------

    def _degree_domain(self, n: int, moe_pins: bool) -> Tuple[int, ...]:
        if moe_pins and self.cfg.family == "moe":
            return (1,)
        return tuple(d for d in (1, 2, 4) if d <= n and n % d == 0)

    def _make_prefill_op(self) -> AutotunedOp:
        cfg, cap = self.cfg, self.max_len
        prefill = self._prefill

        def instantiate(point):
            d = int(point.get("degree", 1))
            if d == 1:
                return lambda params, batch: prefill(params, batch)

            def chunked(params, batch):
                outs = [prefill(params, _batch_chunk(batch, i, d)) for i in range(d)]
                logits = torch.cat([o[0] for o in outs], dim=0)
                return logits, _cache_concat([o[1] for o in outs])

            return chunked

        def shape_class(params, batch) -> BasicParams:
            # the exact group size keys the class (degree validity: chunk
            # counts must divide it); capacity keys the pool row layout
            return BasicParams.make(
                kernel="engine_prefill", arch=cfg.name,
                batch=int(batch["tokens"].shape[0]), capacity=cap,
                backend=self.device.type, **mesh_bp_entries(self.mesh),
            )

        def traffic_class(params, batch) -> TrafficClass:
            B, plen = batch["tokens"].shape
            return TrafficClass.of("prefill", int(B), int(plen))

        def make_region(bp: BasicParams) -> ATRegion:
            # MoE prefill pins degree 1: capacity dispatch couples the group
            space = ParamSpace([
                PerfParam("degree", self._degree_domain(int(bp["batch"]), True))
            ])
            return ATRegion("engine_prefill", space, instantiate)

        spec = register_kernel(
            KernelSpec(
                name=f"engine_prefill/{cfg.name}",
                make_region=make_region,
                shape_class=shape_class,
                tags=("runtime", "serve", "engine"),
                traffic_class=traffic_class,
            ),
            replace=True,
        )
        return AutotunedOp(
            spec, db=self.db, tune=self.inline_tune, warm=False, monitor=False,
            device_key=self.device_key,
        )

    def _make_decode_op(self) -> AutotunedOp:
        cfg, cap = self.cfg, self.max_len
        decode = self._decode

        def instantiate(point):
            d = int(point.get("degree", 1))
            if d == 1:
                # len_hint is scheduler metadata for the traffic class only
                return lambda params, pool, idx, toks, len_hint=0: decode(
                    params, pool, idx, toks
                )

            def chunked(params, pool, idx, toks, len_hint=0):
                n = idx.shape[0] // d
                toks_out, rows = [], []
                for i in range(d):
                    sl = slice(i * n, (i + 1) * n)
                    tok_i, rows_i = decode(params, pool, idx[sl], toks[sl])
                    toks_out.append(tok_i)
                    rows.append(rows_i)
                return torch.cat(toks_out, dim=0), _cache_concat(rows)

            return chunked

        def shape_class(params, pool, idx, toks, len_hint=0) -> BasicParams:
            return BasicParams.make(
                kernel="engine_decode", arch=cfg.name,
                bucket=int(idx.shape[0]), capacity=cap,
                backend=self.device.type, **mesh_bp_entries(self.mesh),
            )

        def traffic_class(params, pool, idx, toks, len_hint=0) -> TrafficClass:
            # context bucketed on the scheduler's python-tracked max row
            # length: no device sync on the hot path
            return TrafficClass.of("decode", int(idx.shape[0]), max(1, int(len_hint)))

        def make_region(bp: BasicParams) -> ATRegion:
            # decode rows are independent even for MoE (one dispatch group
            # a row): decode chunks freely at any degree (unlike prefill)
            space = ParamSpace([
                PerfParam("degree", self._degree_domain(int(bp["bucket"]), False))
            ])
            return ATRegion("engine_decode", space, instantiate)

        spec = register_kernel(
            KernelSpec(
                name=f"engine_decode/{cfg.name}",
                make_region=make_region,
                shape_class=shape_class,
                tags=("runtime", "serve", "engine"),
                traffic_class=traffic_class,
            ),
            replace=True,
        )
        return AutotunedOp(
            spec, db=self.db, tune=self.inline_tune, warm=False, monitor=False,
            device_key=self.device_key,
        )

    def _make_sched_op(self) -> AutotunedOp:
        cfg = self.cfg
        n_blocks = self.cache.n_blocks

        chunk_domain: Tuple[int, ...] = tuple(
            c for c in (2, 4, 1) if c <= n_blocks
        )
        if cfg.family == "moe":
            chunk_domain = (1,)  # grouped MoE prefill couples rows
        if self.shed_policy is not None:
            shed_domain: Tuple[str, ...] = (self.shed_policy,)
        elif self.queue_limit is not None:
            shed_domain = SHED_POLICIES
        else:
            # unbounded queue never sheds: a 1-point domain keeps the
            # search product (and the measured shadow replays) small
            shed_domain = ("reject-new",)
        space = ParamSpace([
            PerfParam("prefill_chunk", chunk_domain),
            PerfParam("interleave", (1, 2)),
            PerfParam("admission", ("fcfs", "sjf")),
            # dict.fromkeys dedupes while keeping order (a 1-block pool
            # would otherwise produce the duplicate domain (1, 1))
            PerfParam("max_in_flight",
                      tuple(dict.fromkeys((n_blocks, max(1, n_blocks // 2))))),
            PerfParam("shed_policy", shed_domain),
        ])

        def instantiate(point):
            # the "kernel body" is just the knob assignment — selection is
            # the product; tuning measures it through the shadow replay
            knobs = dict(point)
            return lambda snapshot: knobs

        def shape_class(snapshot) -> BasicParams:
            return BasicParams.make(
                kernel="serve_scheduler", arch=cfg.name, pool=n_blocks,
                capacity=self.max_len, backend=self.device.type,
                **mesh_bp_entries(self.mesh),
            )

        def traffic_class(snapshot) -> TrafficClass:
            # the *queue state* is the traffic: waiting depth × prompt scale
            return TrafficClass.of(
                "stream",
                max(1, int(snapshot["waiting"])),
                max(1, int(snapshot["mean_plen"])),
            )

        def cost_factory(region, bp, args, kwargs):
            snapshot = args[0]

            def cost(point) -> float:
                # best-of-2 (the paper's repeat-and-take-stable methodology):
                # the first replay of a point can pay first-call costs for
                # group shapes no other point has produced yet, and the worker
                # thread shares the device with the live serve loop — a
                # single sample would hand the win to whichever point
                # happened to measure on a quiet step
                return min(
                    self._shadow_replay(snapshot, dict(point))
                    for _ in range(2)
                )

            return cost

        spec = register_kernel(
            KernelSpec(
                name=f"serve_scheduler/{cfg.name}",
                make_region=lambda bp: ATRegion("serve_scheduler", space, instantiate),
                shape_class=shape_class,
                cost_factory=cost_factory,
                tags=("runtime", "serve", "engine", "scheduler"),
                traffic_class=traffic_class,
            ),
            replace=True,
        )
        return AutotunedOp(
            spec, db=self.db, tune=self.inline_tune, warm=False, monitor=False,
            device_key=self.device_key,
        )

    # -- tuning hand-off (same contract as Server._resolve) ------------------

    def _resolve(self, op: AutotunedOp, *args: Any) -> OpState:
        if self.background is not None:
            # scheduler knobs jump the tuning queue: a tuned scheduler
            # reshapes every later batch, kernel degrees only their own class
            pri = 1 if op is self.sched_op else 0
            state = self.background.submit(
                op, *args, on_complete=self._on_tuned, priority=pri
            )
        else:
            before = op.states() if self.inline_tune else None
            state = op.resolve(*args)
            if (before is not None and state.tuned
                    and state.bp.fingerprint() not in before):
                self._hot_tuned.add(state.bp.fingerprint())
        if state.tuned or state.from_cache:
            self._on_tuned(state)
        return state

    def _on_tuned(self, state: OpState) -> None:
        """Mirror a degree winner into the DegreeController (the scheduler's
        demoted ``omp_set_num_threads`` policy); scheduler-knob states carry
        no degree and pass through untouched."""
        deg = state.region.selected.get("degree")
        if deg is not None and state.traffic is not None:
            self.degree.set_tuned(state.traffic.label, int(deg))

    @property
    def hot_path_cost_evaluations(self) -> int:
        """Tuning cost evaluations paid on the serving thread, by the
        engine's ops and by the kernels the model calls (0 under a
        BackgroundTuner)."""
        total = self.rule.hot_path_cost_evaluations
        for op in (self.prefill_op, self.decode_op, self.sched_op):
            for st in op.states().values():
                if st.bp.fingerprint() in self._hot_tuned:
                    total += st.cost_evaluations
        return total

    @property
    def traffic_classes_seen(self) -> List[str]:
        labels = set()
        for op in (self.prefill_op, self.decode_op, self.sched_op):
            for st in op.states().values():
                if st.traffic is not None:
                    labels.add(st.traffic.label)
        return sorted(labels)

    @property
    def tuned_scheduler_classes(self) -> List[str]:
        return sorted(
            st.traffic.label
            for st in self.sched_op.states().values()
            if st.traffic is not None and (st.tuned or st.from_cache)
        )

    # -- scheduling ----------------------------------------------------------

    def _knobs(
        self, waiting: Sequence[_Waiting], active: Dict[int, _Active]
    ) -> Dict[str, Any]:
        pool = [w.req for w in waiting] or [a.req for a in active.values()]
        mean_plen = int(np.mean([len(r.prompt) for r in pool])) if pool else 1
        mean_mnt = int(np.mean([r.max_new_tokens for r in pool])) if pool else 1
        snapshot = {
            "waiting": max(1, len(waiting)),
            "mean_plen": max(1, mean_plen),
            "mean_mnt": max(1, mean_mnt),
        }
        state = self._resolve(self.sched_op, snapshot)
        return dict(state.region.selected)

    def _safe_knobs(
        self, waiting: Sequence[_Waiting], active: Dict[int, _Active]
    ) -> Dict[str, Any]:
        """Hardened knob resolution: a raising or incomplete tuning path
        degrades to the conservative fallback knobs, never crashes serving."""
        if not self.hardened:
            return self._knobs(waiting, active)
        try:
            knobs = self._knobs(waiting, active)
        except Exception:
            self.stats.knob_faults += 1
            return dict(self._fallback_knobs)
        if all(k in knobs for k in
               ("prefill_chunk", "interleave", "admission", "max_in_flight")):
            return knobs
        self.stats.knob_faults += 1
        return dict(self._fallback_knobs)

    def _pick_group(
        self,
        waiting: List[_Waiting],
        active: Dict[int, _Active],
        knobs: Dict[str, Any],
    ) -> List[_Waiting]:
        """Pop the next prefill group: same exact prompt length (no padding
        → reference-exact logits), bounded by the chunk knob, the in-flight
        ceiling, and the allocator's free blocks.  Higher priority admits
        first; at equal priority the admission knob (fcfs/sjf) orders —
        all-zero priorities reduce to the pre-hardening order exactly."""
        room = min(
            int(knobs["prefill_chunk"]),
            int(knobs["max_in_flight"]) - len(active),
            self.cache.free,
        )
        if room < 1 or not waiting:
            return []
        if knobs["admission"] == "sjf":
            order = sorted(
                range(len(waiting)),
                key=lambda i: (-waiting[i].req.priority,
                               waiting[i].req.max_new_tokens,
                               waiting[i].req.arrival_s,
                               waiting[i].req.rid),
            )
        else:  # fcfs — stable sort keeps queue order within a priority level
            order = sorted(
                range(len(waiting)), key=lambda i: -waiting[i].req.priority
            )
        lead_plen = len(waiting[order[0]].req.prompt)
        chosen = []
        for i in order:
            if len(chosen) >= room:
                break
            if len(waiting[i].req.prompt) == lead_plen:
                chosen.append(i)
        group = [waiting[i] for i in chosen]
        for i in sorted(chosen, reverse=True):
            del waiting[i]
        return group

    # -- hardening helpers ---------------------------------------------------

    def _deadline_of(self, r: ServingRequest) -> Optional[float]:
        dl = getattr(r, "deadline_s", None)
        if dl is not None:
            return float(dl)
        if self.default_ttl_s is not None:
            return float(r.arrival_s) + float(self.default_ttl_s)
        return None

    def _retire(
        self,
        rid: int,
        status: str,
        tokens: Sequence[int],
        now: float,
        out: Dict[int, List[int]],
        detail: str = "",
    ) -> bool:
        """Terminal bookkeeping for one request — idempotent: the first
        retirement wins, every later attempt is a no-op.  Always releases
        the rid's block (cache.release is rid-idempotent)."""
        if rid in self.results:
            return False
        self.results[rid] = RequestResult(
            rid=rid, status=status, tokens=list(tokens), detail=detail
        )
        tr = self._tr()
        if tr is not None:
            # exactly one terminal instant per admitted rid, on the virtual
            # clock (the retire-uniqueness property test keys on this)
            tr.instant(
                "engine.retire", t=now, cat="engine", track="engine",
                rid=rid, status=status, tokens=len(tokens),
            )
        self.cache.release(rid)
        if status == "ok":
            out[rid] = list(tokens)
            self.stats.finish_s[rid] = now
        elif status == "timed_out":
            self.stats.timeouts += 1
        elif status == "shed":
            self.stats.sheds += 1
        elif status == "error":
            self.stats.errors += 1
        return True

    def _admit(
        self,
        r: ServingRequest,
        seen: Set[int],
        waiting: List[_Waiting],
        out: Dict[int, List[int]],
        now: float,
    ) -> None:
        """Hardened admission: malformed requests retire ``error`` on the
        spot; duplicate rids are counted and ignored (the first occurrence
        owns the rid's result slot)."""
        rid = r.rid
        if rid in seen:
            self.duplicate_rids.append(rid)
            self.stats.duplicates += 1
            return
        seen.add(rid)
        plen = len(r.prompt)
        mnt = int(r.max_new_tokens)
        if plen < 1:
            self._retire(rid, "error", [], now, out, detail="malformed: empty prompt")
            return
        if mnt < 1:
            self._retire(
                rid, "error", [], now, out,
                detail=f"malformed: max_new_tokens {mnt} < 1",
            )
            return
        need = plen + mnt - 1
        if need > self.max_len:
            self._retire(
                rid, "error", [], now, out,
                detail=(f"malformed: prompt {plen} + {mnt} new tokens needs "
                        f"{need} KV slots > capacity {self.max_len}"),
            )
            return
        tr = self._tr()
        if tr is not None:
            tr.instant(
                "engine.admit", t=now, cat="engine", track="engine",
                rid=rid, plen=plen, max_new_tokens=mnt,
                queue_wait_s=round(max(0.0, now - float(r.arrival_s)), 9),
            )
        waiting.append(_Waiting(req=r, deadline=self._deadline_of(r)))

    def _expire_deadlines(
        self,
        waiting: List[_Waiting],
        active: Dict[int, _Active],
        out: Dict[int, List[int]],
        now: float,
    ) -> None:
        for w in list(waiting):
            if w.deadline is not None and now >= w.deadline:
                waiting.remove(w)
                self._retire(
                    w.req.rid, "timed_out", w.resume, now, out,
                    detail=f"deadline {w.deadline:.4f}s passed in queue",
                )
        for rid in list(active.keys()):
            a = active[rid]
            if a.deadline is not None and now >= a.deadline:
                del active[rid]
                self._retire(
                    rid, "timed_out", a.gen, now, out,
                    detail=f"deadline {a.deadline:.4f}s passed in flight",
                )

    def _shed(
        self,
        waiting: List[_Waiting],
        out: Dict[int, List[int]],
        now: float,
        policy: str,
    ) -> None:
        while len(waiting) > self.queue_limit:
            if policy == "drop-oldest":
                i = 0
            elif policy == "deadline-aware":
                # least slack first: about to miss its deadline anyway;
                # undeadlined requests (infinite slack) shed newest-first
                i = min(
                    range(len(waiting)),
                    key=lambda j: (
                        waiting[j].deadline if waiting[j].deadline is not None
                        else float("inf"),
                        -waiting[j].req.arrival_s,
                        -waiting[j].req.rid,
                    ),
                )
            else:  # reject-new
                i = len(waiting) - 1
            w = waiting.pop(i)
            self._retire(
                w.req.rid, "shed", w.resume, now, out,
                detail=f"queue over limit {self.queue_limit} ({policy})",
            )

    def _maybe_preempt(
        self, waiting: List[_Waiting], active: Dict[int, _Active],
        now: float = 0.0,
    ) -> bool:
        """Evict the lowest-priority in-flight request when the pool is
        exhausted and a strictly higher-priority admission is blocked.  The
        victim requeues at the front with its generated tokens as replay
        state; ``max_preemptions`` evictions make it non-evictable
        (anti-livelock)."""
        if not waiting or not active or self.cache.free > 0:
            return False
        cand_pri = max(int(w.req.priority) for w in waiting)
        eligible = [
            a for a in active.values() if a.preemptions < self.max_preemptions
        ]
        if not eligible:
            return False
        victim = min(
            eligible,
            key=lambda a: (int(a.req.priority), -a.req.arrival_s, -a.req.rid),
        )
        if cand_pri <= int(victim.req.priority):
            return False
        rid = victim.req.rid
        tr = self._tr()
        if tr is not None:
            tr.instant(
                "engine.preempt", t=now, cat="engine", track="engine",
                rid=rid, priority=int(victim.req.priority),
                preemptions=victim.preemptions + 1,
            )
        del active[rid]
        self.cache.release(rid)
        waiting.insert(0, _Waiting(
            req=victim.req,
            resume=list(victim.gen),
            preemptions=victim.preemptions + 1,
            deadline=victim.deadline,
        ))
        self.stats.preempted += 1
        return True

    def _idle_advance(
        self,
        now: float,
        reqs: Sequence[ServingRequest],
        cursor: int,
        waiting: Sequence[_Waiting],
        active: Dict[int, _Active],
    ) -> float:
        """No progress this iteration (hardened): jump the virtual clock to
        the nearest future event (arrival or deadline) so timeouts and
        admissions stay reachable; a fixed tick when there is none."""
        targets: List[float] = []
        if cursor < len(reqs):
            targets.append(reqs[cursor].arrival_s)
        targets.extend(w.deadline for w in waiting if w.deadline is not None)
        targets.extend(
            a.deadline for a in active.values() if a.deadline is not None
        )
        future = [t for t in targets if t > now]
        nxt = max(min(future) if future else now, now + _STALL_TICK_S)
        self.stats.idle_s += nxt - now
        return nxt

    def _state_dump(
        self,
        waiting: Sequence[_Waiting],
        active: Dict[int, _Active],
        now: float,
        idle_iters: int,
    ) -> str:
        return (
            f"engine stalled: no progress for {idle_iters} iterations "
            f"(watchdog_limit={self.watchdog_limit}) at t={now:.4f}s | "
            f"waiting={[w.req.rid for w in waiting]} "
            f"active={sorted(active)} "
            f"free_blocks={self.cache.free}/{self.cache.n_blocks} "
            f"block_table={dict(self.cache.block_table)} "
            f"retired={len(self.results)} "
            f"chaos_holding={getattr(self.chaos, 'holding', 0)}"
        )

    # -- serve ---------------------------------------------------------------

    def serve(self, requests: Sequence[ServingRequest]) -> Dict[int, List[int]]:
        """Greedy-decode an open-loop trace; returns rid → generated tokens
        for the ``ok`` requests (``self.results`` has every terminal
        status)."""
        self.results = {}
        self.duplicate_rids = []
        self._delivered = set()
        if not self.hardened:
            # pre-hardening contract: malformed input raises to the caller
            check_unique_rids(requests)
            for r in requests:
                need = len(r.prompt) + r.max_new_tokens - 1
                if need > self.max_len:
                    raise ValueError(
                        f"request {r.rid}: prompt {len(r.prompt)} + "
                        f"{r.max_new_tokens} new tokens needs {need} KV slots "
                        f"> capacity {self.max_len}"
                    )
        reqs = sorted(requests, key=lambda r: (r.arrival_s, r.rid))
        out: Dict[int, List[int]] = {}
        if not reqs:
            return out
        now = reqs[0].arrival_s
        t_start = now
        cursor = 0
        waiting: List[_Waiting] = []
        active: Dict[int, _Active] = {}
        seen: Set[int] = set()
        idle_iters = 0

        while cursor < len(reqs) or waiting or active:
            while cursor < len(reqs) and reqs[cursor].arrival_s <= now:
                r = reqs[cursor]
                cursor += 1
                if self.hardened:
                    self._admit(r, seen, waiting, out, now)
                else:
                    waiting.append(_Waiting(req=r))
            if self.chaos is not None:
                self.chaos.tick(self.cache)
            if self.hardened:
                self._expire_deadlines(waiting, active, out, now)
            if not waiting and not active:
                if cursor < len(reqs):
                    # nothing runnable: the open-loop clock jumps to the
                    # next arrival instead of sleeping
                    self.stats.idle_s += reqs[cursor].arrival_s - now
                    now = reqs[cursor].arrival_s
                    continue
                break  # everything retired; chaos may still hold blocks
            n_retired = len(self.results)
            knobs = self._safe_knobs(waiting, active)
            if self.hardened and self.queue_limit is not None:
                policy = self.shed_policy or str(
                    knobs.get("shed_policy", "reject-new")
                )
                self._shed(waiting, out, now, policy)
            if self.hardened:
                self._maybe_preempt(waiting, active, now)

            progressed = False
            group = self._pick_group(waiting, active, knobs)
            if group:
                now = self._prefill_step(group, active, waiting, out, now)
                progressed = True
            for _ in range(int(knobs["interleave"])):
                if not active:
                    break
                now = self._decode_step(active, out, now)
                progressed = True
            if len(self.results) > n_retired:
                progressed = True  # sheds/timeouts/errors are retirements
            self.stats.peak_in_flight = max(
                self.stats.peak_in_flight, len(active)
            )
            if progressed:
                idle_iters = 0
            else:
                if not self.hardened:
                    # waiting but no admission room and nothing decoding can
                    # only mean a stuck ceiling; active==∅ implies room ≥ 1
                    raise RuntimeError("scheduler stalled: no admissible work")
                idle_iters += 1
                if idle_iters > self.watchdog_limit:
                    raise EngineStalled(
                        self._state_dump(waiting, active, now, idle_iters)
                    )
                now = self._idle_advance(now, reqs, cursor, waiting, active)
        if self.chaos is not None:
            self.chaos.drain(self.cache)
        self.stats.makespan_s += now - t_start
        tr = self._tr()
        if tr is not None:
            tr.complete(
                "engine.serve", t_start, now, cat="engine", track="engine",
                requests=len(reqs), retired=len(self.results),
                tokens_out=self.stats.tokens_out,
            )
        return out

    # -- prefill -------------------------------------------------------------

    def _prefill_step(
        self,
        group: List[_Waiting],
        active: Dict[int, _Active],
        waiting: List[_Waiting],
        out: Dict[int, List[int]],
        now: float,
    ) -> float:
        if not self.hardened:
            return self._prefill_exec(group, active, waiting, out, now)
        try:
            return self._prefill_exec(group, active, waiting, out, now)
        except Exception:
            self.stats.step_faults += 1
            # undo partial state: blocks allocated to members that never
            # activated (cache.release is rid-idempotent)
            for w in group:
                if w.req.rid not in active:
                    self.cache.release(w.req.rid)
            # isolate: retry each not-yet-settled member on its own; a
            # member that raises again is the implicated request
            for w in group:
                rid = w.req.rid
                if (rid in self.results or rid in active
                        or any(q.req.rid == rid for q in waiting)):
                    continue
                try:
                    now = self._prefill_exec([w], active, waiting, out, now)
                except Exception as exc:
                    self._retire(
                        rid, "error", w.resume, now, out,
                        detail=f"prefill fault: {type(exc).__name__}: {exc}",
                    )
            return now

    def _prefill_exec(
        self,
        group: List[_Waiting],
        active: Dict[int, _Active],
        waiting: List[_Waiting],
        out: Dict[int, List[int]],
        now: float,
    ) -> float:
        reqs = [w.req for w in group]
        plen = len(reqs[0].prompt)
        batch = build_batch_inputs(self.cfg, reqs, plen, self.device)
        pstate = self._resolve(self.prefill_op, self.params, batch)
        label = pstate.traffic.label if pstate.traffic else "prefill"
        if self.chaos is not None:
            self.chaos.before_step("prefill", [r.rid for r in reqs])
        t0 = self._timer()
        with self.degree.region(label):
            logits, cache = pstate.region(self.params, batch)
            sync(self.device)
        dt = self._timer() - t0
        self.stats.prefill_s += dt
        self.stats.prefill_steps += 1
        t_v0 = now
        now += dt
        if self.chaos is not None:
            now += self.chaos.step_delay()
        tr = self._tr()
        if tr is not None:
            tr.complete(
                "engine.prefill", t_v0, now, cat="engine", track="engine",
                rids=[r.rid for r in reqs], batch=len(reqs), plen=plen,
                label=label,
            )
        if pstate.selector is not None and pstate.selector.observe(dt):
            self._on_tuned(pstate)
        toks = greedy(logits).tolist()
        # a resumed (preempted) request forces its first delivered token:
        # greedy decode reproduces it anyway, forcing guarantees bit-match
        first_toks: Dict[int, int] = {}
        for i, w in enumerate(group):
            r = w.req
            tok0 = int(w.resume[0]) if w.resume else int(toks[i])
            first_toks[r.rid] = tok0
            if r.rid not in self._delivered:
                self._delivered.add(r.rid)
                self.stats.ttft_s[r.rid] = now - r.arrival_s
                self.stats.tokens_out += 1
            if r.max_new_tokens <= 1:
                # done at first token: never allocates a block
                self._retire(r.rid, "ok", [tok0], now, out)
        keep_idx: List[int] = []
        activated: List[_Waiting] = []
        for i, w in enumerate(group):
            if w.req.max_new_tokens <= 1:
                continue
            try:
                self.cache.allocate(w.req.rid)
            except KVPoolExhausted:
                if not self.hardened:
                    raise
                # pool raced away (e.g. chaos squeeze between pick and
                # allocate): requeue at the front with recompute state
                resume = list(w.resume) if w.resume else [first_toks[w.req.rid]]
                waiting.insert(0, _Waiting(
                    req=w.req, resume=resume,
                    preemptions=w.preemptions, deadline=w.deadline,
                ))
                continue
            keep_idx.append(i)
            activated.append(w)
        if activated:
            if len(keep_idx) < len(group):
                # drop the retired/deferred rows before scattering
                cache = _take_rows(cache, torch.tensor(keep_idx, device=self.device))
            self.cache.insert([w.req.rid for w in activated], cache)
            for w in activated:
                r = w.req
                tok0 = first_toks[r.rid]
                active[r.rid] = _Active(
                    req=r, block=self.cache.block_of(r.rid),
                    gen=[tok0], last_tok=tok0, ctx=plen,
                    replay=list(w.resume[1:]),
                    preemptions=w.preemptions, deadline=w.deadline,
                )
        return now

    # -- decode --------------------------------------------------------------

    def _decode_step(
        self, active: Dict[int, _Active], out: Dict[int, List[int]], now: float
    ) -> float:
        if not self.hardened:
            return self._decode_exec(active, out, now)
        try:
            return self._decode_exec(active, out, now)
        except Exception:
            self.stats.step_faults += 1
            # isolate: step each row on its own; a row that raises again is
            # the implicated request (its KV pool state is untouched — the
            # step decodes gathered copies, scattered back only on success)
            for rid in list(active.keys()):
                if rid not in active:
                    continue
                try:
                    now = self._decode_exec(active, out, now, only=[rid])
                except Exception as exc:
                    a = active.pop(rid)
                    self._retire(
                        rid, "error", a.gen, now, out,
                        detail=f"decode fault: {type(exc).__name__}: {exc}",
                    )
            return now

    def _decode_exec(
        self,
        active: Dict[int, _Active],
        out: Dict[int, List[int]],
        now: float,
        only: Optional[Sequence[int]] = None,
    ) -> float:
        rids = [
            r for r in (list(active.keys()) if only is None else only)
            if r in active
        ]
        act = [active[r] for r in rids]
        A = len(act)
        if A == 0:
            return now
        bucket = bucket_pow2(A)
        # pad to the pow2 bucket by replicating row 0: replicas compute the
        # identical update, so duplicate scatter indices write equal values
        # (well-defined) and the compile cache stays per-bucket, not per-A
        idx = [a.block for a in act] + [act[0].block] * (bucket - A)
        toks = [a.last_tok for a in act] + [act[0].last_tok] * (bucket - A)
        idx_arr = torch.tensor(idx, dtype=torch.int64, device=self.device)
        tok_arr = torch.tensor(toks, dtype=torch.int32, device=self.device)
        len_hint = max(a.ctx for a in act)
        dstate = self._resolve(
            self.decode_op, self.params, self.cache.pool, idx_arr, tok_arr,
            len_hint,
        )
        label = dstate.traffic.label if dstate.traffic else "decode"
        if self.chaos is not None:
            self.chaos.before_step("decode", rids)
        t0 = self._timer()
        with self.degree.region(label):
            new_tok, rows = dstate.region(
                self.params, self.cache.pool, idx_arr, tok_arr, len_hint
            )
            # only the A real rows go back: the padding replicates row 0,
            # and duplicate indices must never reach index_copy_
            self.cache.scatter(idx_arr, rows, A)
            sync(self.device)
        dt = self._timer() - t0
        self.stats.decode_s += dt
        self.stats.decode_steps += 1
        t_v0 = now
        now += dt
        if self.chaos is not None:
            now += self.chaos.step_delay()
        tr = self._tr()
        if tr is not None:
            tr.complete(
                "engine.decode", t_v0, now, cat="engine", track="engine",
                rids=rids, batch=A, bucket=bucket, label=label,
            )
        if dstate.selector is not None and dstate.selector.observe(dt):
            self._on_tuned(dstate)
        new_np = new_tok[:A].tolist()
        for a, t in zip(act, new_np):
            if a.replay:
                # recompute of an already-delivered token (post-preemption):
                # force the original trajectory, don't re-count delivery
                tok = int(a.replay.pop(0))
            else:
                tok = int(t)
                self.stats.tokens_out += 1
            a.gen.append(tok)
            a.last_tok = tok
            a.ctx += 1
            if len(a.gen) >= a.req.max_new_tokens:
                self._retire(a.req.rid, "ok", a.gen, now, out)
                del active[a.req.rid]
        return now

    # -- scheduler-knob cost: measured shadow replay -------------------------

    def _shadow_replay(self, snapshot: Dict[str, int], knobs: Dict[str, Any]) -> float:
        """Cost of one knob assignment: replay a deterministic mini-trace
        shaped like the snapshot's traffic class through the raw jitted
        primitives (no op dispatch, no degree bracket, fresh pool) on a
        virtual clock.  Runs on the BackgroundTuner's worker thread; cost =
        virtual makespan + p99 TTFT + a fixed penalty per shed request, so
        knobs that starve admissions, waste decode slots, or shed their way
        to a short makespan all lose.
        """
        plen = max(1, min(int(snapshot["mean_plen"]), self.max_len - 6))
        n = int(min(max(2, snapshot["waiting"]), 4))
        rng = np.random.default_rng(
            np.random.SeedSequence([plen, n, 0x5C4ED])
        )
        mini: List[ServingRequest] = []
        for i in range(n):
            mnt = max(1, min(int(snapshot["mean_mnt"]) + 2 * (i % 2), 5))
            prompt = rng.integers(
                0, self.cfg.vocab_size - 1, size=plen
            ).astype(np.int32)
            # alternating finite deadlines give the deadline-aware shed
            # policy something to distinguish itself on
            mini.append(ServingRequest(
                rid=i, prompt=prompt, max_new_tokens=mnt,
                deadline_s=0.05 * (i + 1) if i % 2 else None,
            ))

        shadow = PagedKVCache(self.cfg, self.cache.n_blocks, self.max_len, self.device)
        waiting = list(mini)
        shed = 0
        if self.queue_limit is not None:
            # bound the shadow queue below the mini-trace size so the shed
            # policies produce genuinely different traces (and costs)
            limit = max(1, min(int(self.queue_limit), n - 1))
            policy = str(knobs.get("shed_policy", "reject-new"))
            while len(waiting) > limit:
                if policy == "drop-oldest":
                    j = 0
                elif policy == "deadline-aware":
                    j = min(
                        range(len(waiting)),
                        key=lambda q: (
                            waiting[q].deadline_s
                            if waiting[q].deadline_s is not None
                            else float("inf"),
                            -waiting[q].rid,
                        ),
                    )
                else:  # reject-new
                    j = len(waiting) - 1
                waiting.pop(j)
                shed += 1
        active: Dict[int, _Active] = {}
        now = 0.0
        ttft: List[float] = []
        while waiting or active:
            room = min(
                int(knobs["prefill_chunk"]),
                int(knobs["max_in_flight"]) - len(active),
                shadow.free,
            )
            if waiting and room >= 1:
                if knobs["admission"] == "sjf":
                    waiting.sort(key=lambda r: (r.max_new_tokens, r.rid))
                group, waiting = waiting[:room], waiting[room:]
                batch = build_batch_inputs(self.cfg, group, plen, self.device)
                t0 = time.perf_counter()
                logits, cache = self._prefill_raw(self.params, batch)
                sync(self.device)
                now += time.perf_counter() - t0
                toks = greedy(logits).tolist()
                survivors = [r for r in group if r.max_new_tokens > 1]
                ttft.extend(now for _ in group)
                if survivors:
                    for r in survivors:
                        shadow.allocate(r.rid)
                    if len(survivors) < len(group):
                        keep = torch.tensor(
                            [i for i, r in enumerate(group)
                             if r.max_new_tokens > 1], device=self.device,
                        )
                        cache = _take_rows(cache, keep)
                    shadow.insert([r.rid for r in survivors], cache)
                    for i, r in enumerate(group):
                        if r.max_new_tokens > 1:
                            active[r.rid] = _Active(
                                req=r, block=shadow.block_of(r.rid),
                                gen=[int(toks[i])], last_tok=int(toks[i]),
                                ctx=plen,
                            )
            for _ in range(int(knobs["interleave"])):
                if not active:
                    break
                act = list(active.values())
                A = len(act)
                bucket = bucket_pow2(A)
                idx = [a.block for a in act] + [act[0].block] * (bucket - A)
                tk = [a.last_tok for a in act] + [act[0].last_tok] * (bucket - A)
                idx_arr = torch.tensor(idx, dtype=torch.int64, device=self.device)
                t0 = time.perf_counter()
                new_tok, rows = self._decode_raw(
                    self.params, shadow.pool, idx_arr,
                    torch.tensor(tk, dtype=torch.int32, device=self.device),
                )
                shadow.scatter(idx_arr, rows, A)
                sync(self.device)
                now += time.perf_counter() - t0
                new_np = new_tok[:A].tolist()
                for a, t in zip(act, new_np):
                    a.gen.append(int(t))
                    a.last_tok = int(t)
                    if len(a.gen) >= a.req.max_new_tokens:
                        shadow.release(a.req.rid)
                        del active[a.req.rid]
        p99 = float(np.percentile(np.asarray(ttft), 99)) if ttft else 0.0
        return now + p99 + _SHED_COST_S * shed


# ---------------------------------------------------------------------------
# batched decode over gathered pool rows
# ---------------------------------------------------------------------------


def _make_decode_rows(cfg: ModelConfig, rule: ServingRule):
    """The engine's decode step: gather rows → decode them at their own
    positions → (greedy tokens, the stepped rows).  The pool itself is not
    written: the caller scatters the rows back once the step returned.

    The gathered rows are the model's cache at batch ``len(idx)`` with a
    per-row ``len``, so heterogeneous positions advance independently, as
    the JAX engine's ``vmap`` of the batch-1 decode does.  MoE rows
    dispatch one token a group (``moe_groups`` = rows): each row's own
    batch-1 dispatch, with its own capacity.
    """

    def decode_rows(params, pool, idx, toks):
        rows = _take_rows(pool, idx)
        step_cfg = cfg.with_(moe_groups=int(idx.shape[0])) if cfg.family == "moe" else cfg
        with serving(rule):
            logits, rows = decode_fn(params, decode_inputs(cfg, toks, rows["len"]), rows,
                                     step_cfg)
        return greedy(logits), rows

    return decode_rows


def _take_rows(cache: Dict[str, Any], keep: torch.Tensor) -> Dict[str, Any]:
    """Copies of a row subset of a batched cache dict, along each leaf's
    batch axis (an int ``len`` passes through)."""
    out = {}
    for k, v in cache.items():
        ax = cache_batch_axis(k, getattr(v, "ndim", 0))
        out[k] = v if ax is None else v.index_select(ax, keep)
    return out
