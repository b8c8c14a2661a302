"""Sharded fleet search: N workers, one deterministic winner.

The port's copy of ``repro.fleet.coordinator``.

ppOpen-AT's before-execution layer measures every generated candidate on one
machine, serially.  Nothing in that layer is sequential *in principle* —
candidates are independent — so the fleet coordinator partitions a
:class:`~repro_torch.core.params.ParamSpace` across N workers and recovers the
single-process result by construction:

1. **shard** — ``space.shard(n, policy)`` deals every feasible point into
   exactly one shard (``stride`` round-robin or ``block`` contiguous);
2. **scatter** — each worker runs the *existing* search machinery
   (:class:`~repro_torch.core.search.ExhaustiveSearch` by default, a
   :class:`~repro_torch.core.search.StagedSearch` via ``search_factory``) over its
   shard, recording every trial into its own scratch
   :class:`~repro_torch.core.db.TuningDB` — workers never contend on one entry;
3. **sync** — every ``sync_every`` trials a worker's scratch state is pushed
   out (thread backend: merged into the live target DB; spawn backend:
   flushed to the worker's scratch file), so a crashed fleet run resumes
   from whatever any worker had finished;
4. **merge barrier** — the coordinator unions all scratch DBs with
   :meth:`TuningDB.merge` (a deterministic lattice join: commutative,
   associative, idempotent), takes the argmin over the merged trials, and
   records it as the *final* best.  Because the shards partition the space
   and merge keeps the minimum cost per point, the fleet winner equals the
   single-process exhaustive winner for any worker count and shard policy.

Two worker backends: ``thread`` (in-process; closures work, so a kernel's
measured cost over live CUDA tensors runs here) and ``spawn``
(``multiprocessing`` — true parallelism for Python-bound costs; the cost
callable must be picklable, i.e. a module-level function or instance, and
CUDA tensors do not cross the boundary).  Thread workers on one card time
one at a time: the port's measured cost holds the card's timing lock over
a point's launches and timed runs (:func:`repro_torch.core.cost.timing_lock`),
since concurrent timing on shared hardware measures contention, not
candidates.  What overlaps is the host's work between timed windows.
"""
from __future__ import annotations

import json
import os
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

from ..core.db import TuningDB
from ..core.params import BasicParams, ParamSpace, PerfParam, pp_key
from ..core.search import ExhaustiveSearch, Search, SearchResult, Trial

SHARD_POLICIES = ("stride", "block")
BACKENDS = ("thread", "spawn", "remote")


@dataclass
class WorkerReport:
    """What one fleet worker did — the operator/bench observability unit."""

    worker: int
    points: int                 # shard size (assigned candidates)
    evaluations: int            # cost evaluations the worker actually ran
    wall_s: float
    best_point: Dict[str, Any]
    best_cost: float
    scratch_path: Optional[str] = None
    resumed: int = 0            # trials recovered from a synced scratch DB
    crashed: bool = False       # the worker process died mid-shard

    def as_metrics(self) -> Dict[str, float]:
        """Flat numeric snapshot for the metrics registry
        (:func:`repro_torch.obs.metrics.snapshot_stats` protocol)."""
        return {
            "points": self.points,
            "evaluations": self.evaluations,
            "wall_s": self.wall_s,
            "best_cost": self.best_cost,
            "resumed": self.resumed,
            "crashed": int(self.crashed),
        }


@dataclass
class FleetResult:
    """The merge barrier's output: the fleet winner plus per-worker stats."""

    result: SearchResult
    workers: List[WorkerReport] = field(default_factory=list)
    merged: Optional[TuningDB] = None
    shard_policy: str = "stride"
    backend: str = "thread"
    # remote backend only: did the barrier reconcile with the tuning
    # service (None = no service attached, False = degraded local-only)
    service_synced: Optional[bool] = None

    @property
    def best(self) -> Trial:
        return self.result.best

    @property
    def evaluations(self) -> int:
        return self.result.evaluations


def _shard_search(
    shard: ParamSpace,
    cost: Callable[[Mapping[str, Any]], float],
    bp: BasicParams,
    layer: str,
    scratch: TuningDB,
    sync_every: int,
    sync: Optional[Callable[[TuningDB], None]],
    search: Optional[Search],
) -> SearchResult:
    """Run one worker's shard with trial recording + periodic sync."""
    count = 0

    def recording_cost(point: Mapping[str, Any]) -> float:
        nonlocal count
        c = float(cost(point))
        scratch.record_trial(bp, point, c, layer)
        count += 1
        if sync is not None and sync_every > 0 and count % sync_every == 0:
            sync(scratch)
        return c

    return (search or ExhaustiveSearch()).run(shard, recording_cost)


def _space_from_points(points: Sequence[Mapping[str, Any]]) -> ParamSpace:
    """Rebuild an explicit-membership space from a pickled point list.

    A shard crosses the spawn boundary as plain dicts (constraints and
    parent spaces don't pickle); the worker re-wraps them so the existing
    Search strategies run unchanged.  Domains are the observed values —
    every listed point is feasible by construction (the parent filtered).
    """
    names = sorted(points[0])
    domains: Dict[str, List[Any]] = {n: [] for n in names}
    for p in points:
        for n in names:
            v = p[n]
            if all(repr(v) != repr(d) for d in domains[n]):
                domains[n].append(v)
    parent = ParamSpace([PerfParam(n, tuple(domains[n])) for n in names])
    return parent.subset(points)


def _spawn_worker(payload: Tuple) -> Tuple[int, List[Tuple[Dict, float]], float, int]:
    """Module-level spawn target (must be importable from the child).

    Crash-resume: when the worker's scratch file survives a previous run
    (the coordinator died, or this worker was killed and retried), its
    synced trials are recovered and only the *remaining* points are
    measured — an interrupted shard costs the unsynced tail, never the
    whole shard.
    """
    (idx, points, bp_entries, cost, layer, scratch_path, sync_every) = payload
    bp = BasicParams.make(**bp_entries)
    scratch = TuningDB()
    resumed = 0
    if scratch_path and os.path.exists(scratch_path):
        try:
            scratch.merge(TuningDB(scratch_path))
        except (ValueError, OSError):
            pass  # half-written scratch: re-measure the whole shard
        done = scratch.trials(bp)
        resumed = len(done)
        points = [p for p in points if pp_key(p) not in done]
    t0 = time.perf_counter()

    def sync(db: TuningDB) -> None:
        if scratch_path:
            db.save(scratch_path)

    if points:
        _shard_search(
            _space_from_points(points), cost, bp, layer, scratch,
            sync_every, sync, search=None,
        )
    sync(scratch)
    wall = time.perf_counter() - t0
    # all trials (resumed + new) so the parent's merge barrier sees the
    # recovered ones too; ``resumed`` lets it count real evaluations
    all_trials = [
        (json.loads(k), float(c))
        for k, c in sorted(scratch.trials(bp).items())
    ]
    return idx, all_trials, wall, resumed


class FleetCoordinator:
    """Deterministic scatter/merge orchestration of one PP search.

    Parameters mirror the ``launch/fleet.py`` CLI: ``workers`` (N),
    ``shard_policy`` (``stride``/``block``), ``backend``
    (``thread``/``spawn``/``remote``), ``sync_every`` (trials between
    scratch-DB syncs; 0 = barrier-only), ``scratch_dir`` (where
    per-worker scratch DBs persist; required for spawn crash-resume,
    optional for thread), and ``search_factory(worker_idx, shard) ->
    Search`` to run something other than exhaustive per shard (thread
    backend only — a staged search's prescreen closure doesn't pickle).

    The global-tuning-service extensions:

    * ``service`` — a :class:`~repro_torch.fleet.service.ServiceClient`.  Thread
      workers push scratch state on every periodic sync; every backend
      reconciles at the merge barrier (``sync`` = push + pull, so re-tune
      requests and other hosts' trials land here too) and pushes the
      final winner.  All service traffic is best-effort: a partitioned
      or dead service degrades the run to local-only, never fails it.
    * ``backend="remote"`` — thread workers plus a *mandatory* service:
      the topology for a multi-host fleet, where the service is the only
      shared state.
    * ``hosts``/``host_index`` — multi-host sharding: the space is first
      dealt across ``hosts`` (same shard policy), and this coordinator
      only measures host ``host_index``'s slice; the service's lattice
      join unions the host results, so the fleet winner still equals the
      single-process winner once every host has pushed.
    * ``keep_scratch`` — leave per-worker scratch files on disk after a
      successful barrier.  Default off: the barrier removes this run's
      scratch files *and* any orphaned ``fleet_worker_*.json`` left by a
      previous crashed run in the same ``scratch_dir`` (their synced
      trials have either been recovered by resume or superseded).
    """

    def __init__(
        self,
        workers: int = 2,
        shard_policy: str = "stride",
        backend: str = "thread",
        sync_every: int = 8,
        scratch_dir: Optional[str] = None,
        search_factory: Optional[Callable[[int, ParamSpace], Search]] = None,
        service: Optional[Any] = None,  # ServiceClient (duck-typed)
        hosts: int = 1,
        host_index: int = 0,
        keep_scratch: bool = False,
    ) -> None:
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        if shard_policy not in SHARD_POLICIES:
            raise ValueError(
                f"unknown shard policy {shard_policy!r}; expected {SHARD_POLICIES}"
            )
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; expected {BACKENDS}")
        if backend == "spawn" and search_factory is not None:
            raise ValueError("search_factory is thread-backend only "
                             "(search closures don't pickle)")
        if backend == "remote" and service is None:
            raise ValueError("backend 'remote' requires a service client "
                             "(the service is the only shared state)")
        if hosts < 1:
            raise ValueError(f"hosts must be >= 1, got {hosts}")
        if not 0 <= host_index < hosts:
            raise ValueError(
                f"host_index must be in [0, {hosts}), got {host_index}"
            )
        self.workers = workers
        self.shard_policy = shard_policy
        self.backend = backend
        self.sync_every = sync_every
        self.scratch_dir = scratch_dir
        self.search_factory = search_factory
        self.service = service
        self.hosts = hosts
        self.host_index = host_index
        self.keep_scratch = keep_scratch

    # -- public ----------------------------------------------------------------

    def search(
        self,
        space: ParamSpace,
        cost: Callable[[Mapping[str, Any]], float],
        bp: Optional[BasicParams] = None,
        db: Optional[TuningDB] = None,
        layer: str = "before_execution",
        space_signature: Optional[str] = None,
    ) -> FleetResult:
        """Scatter ``space`` across the fleet, merge, return the winner.

        ``space_signature`` (the region's, for an emitted space) stamps the
        recorded final, so an :class:`~repro_torch.core.autotuned.AutotunedOp`
        on ``bp`` recalls it instead of invalidating it as stale.

        ``db`` (optional) is the live target: thread workers sync their
        scratch results into it every ``sync_every`` trials, and the merge
        barrier lands the union plus the final best there.  Without it the
        merged view lives on :attr:`FleetResult.merged` only.

        With a ``service`` attached the barrier also reconciles globally:
        after the local scratch union it syncs with the service (pushing
        this host's trials, pulling every other host's), takes the argmin
        over the *union*, records that as final, and pushes the final
        entry back.  Trials partition across hosts and the join keeps the
        per-point minimum, so once the last host's barrier lands, the
        service-side final equals the single-process exhaustive winner.
        """
        bp = bp or BasicParams.make(kernel="fleet")
        if self.hosts > 1:
            host_shards = space.shard(self.hosts, self.shard_policy)
            if self.host_index >= len(host_shards):
                raise ValueError(
                    f"host {self.host_index} got an empty shard: the space "
                    f"has too few points for {self.hosts} hosts"
                )
            space = host_shards[self.host_index]
        shards = space.shard(self.workers, self.shard_policy)
        if self.backend == "spawn":
            reports, scratches = self._run_spawn(shards, cost, bp, layer)
        else:  # thread and remote both run in-process workers
            reports, scratches = self._run_threads(shards, cost, bp, layer, db)

        # The merge barrier.  TuningDB.merge is a deterministic lattice
        # join, so the landing order of scratch DBs cannot change the
        # merged state — the fleet-equivalence property the tests pin.
        merged = db if db is not None else TuningDB()
        for scratch in scratches:
            merged.merge(scratch)

        service_synced: Optional[bool] = None
        if self.service is not None:
            # push our trials / pull everyone else's, *then* take the
            # argmin — the recorded final reflects the global union, not
            # just this host's slice.  Best-effort: a dead service
            # degrades to local-only (service_synced=False).
            service_synced = self.service.try_sync(merged) is not None

        trials = merged.trials(bp)
        if not trials:
            raise ValueError("fleet search produced no trials")
        best_key = min(trials, key=lambda k: (trials[k], k))
        best = Trial(json.loads(best_key), float(trials[best_key]))
        merged.record_best(bp, best.point, best.cost, layer,
                           space_signature=space_signature)

        if self.service is not None and service_synced:
            service_synced = self.service.try_push(
                merged, [bp.fingerprint()]
            )

        if not self.keep_scratch:
            self._cleanup_scratch(scratches)

        all_trials = [Trial(json.loads(k), float(c)) for k, c in sorted(trials.items())]
        result = SearchResult(
            best=best, trials=all_trials,
            evaluations=sum(r.evaluations for r in reports),
        )
        return FleetResult(
            result=result, workers=reports, merged=merged,
            shard_policy=self.shard_policy, backend=self.backend,
            service_synced=service_synced,
        )

    def as_search(
        self,
        bp: Optional[BasicParams] = None,
        db: Optional[TuningDB] = None,
        layer: str = "before_execution",
    ) -> "FleetSearch":
        """This coordinator as a plain Search — the Tuner/AutotunedOp hook."""
        return FleetSearch(self, bp=bp, db=db, layer=layer)

    # -- backends --------------------------------------------------------------

    def _scratch_path(self, idx: int) -> Optional[str]:
        if not self.scratch_dir:
            return None
        os.makedirs(self.scratch_dir, exist_ok=True)
        return os.path.join(self.scratch_dir, f"fleet_worker_{idx}.json")

    def _cleanup_scratch(self, scratches: List[TuningDB]) -> None:
        """Remove this run's scratch files + orphans after a clean barrier.

        Orphans are ``fleet_worker_*.json`` left behind by a previous run
        that crashed before *its* barrier (e.g. a larger worker count):
        their synced trials were either recovered by crash-resume or
        superseded by this run, so keeping them only risks a stale resume.
        """
        if not self.scratch_dir:
            return
        paths = {s.path for s in scratches if s.path}
        try:
            for name in os.listdir(self.scratch_dir):
                full = os.path.join(self.scratch_dir, name)
                if full in paths or (
                    name.startswith("fleet_worker_") and name.endswith(".json")
                ):
                    try:
                        os.remove(full)
                    except OSError:
                        pass  # already gone / permissions: never fail a run
        except OSError:
            pass

    def _run_threads(
        self, shards, cost, bp, layer, target: Optional[TuningDB]
    ) -> Tuple[List[WorkerReport], List[TuningDB]]:
        scratches = [TuningDB(self._scratch_path(i)) for i in range(len(shards))]
        service = self.service

        def sync(scratch: TuningDB) -> None:
            if target is not None:
                target.merge(scratch)
            if service is not None:
                # periodic push keeps the service warm mid-run, so other
                # hosts' pulls and crash-resume see partial progress.
                # Best-effort by construction: push is an idempotent join,
                # a drop just waits for the next sync or the barrier.
                service.try_push(scratch)

        has_sync = target is not None or service is not None
        sync_fn = sync if has_sync else None

        def run(idx: int) -> WorkerReport:
            shard = shards[idx]
            search = (
                self.search_factory(idx, shard) if self.search_factory else None
            )
            t0 = time.perf_counter()
            result = _shard_search(
                shard, cost, bp, layer, scratches[idx],
                self.sync_every, sync_fn, search,
            )
            return WorkerReport(
                worker=idx,
                points=sum(1 for _ in shard.points()),
                evaluations=result.evaluations,
                wall_s=time.perf_counter() - t0,
                best_point=dict(result.best.point),
                best_cost=float(result.best.cost),
                scratch_path=scratches[idx].path,
            )

        with ThreadPoolExecutor(max_workers=len(shards)) as pool:
            reports = list(pool.map(run, range(len(shards))))
        return reports, scratches

    def _run_spawn(
        self, shards, cost, bp, layer
    ) -> Tuple[List[WorkerReport], List[TuningDB]]:
        import multiprocessing as mp

        payloads = []
        shard_points = []
        for idx, shard in enumerate(shards):
            points = [dict(p) for p in shard.points()]
            shard_points.append(points)
            payloads.append((
                idx, points, bp.asdict(), cost, layer,
                self._scratch_path(idx), self.sync_every,
            ))
        ctx = mp.get_context("spawn")
        outcomes: Dict[int, Tuple[List[Tuple[Dict, float]], float, int]] = {}
        crashed: List[int] = []
        with ProcessPoolExecutor(
            max_workers=len(shards), mp_context=ctx
        ) as pool:
            futures = {
                idx: pool.submit(_spawn_worker, payloads[idx])
                for idx in range(len(shards))
            }
            for idx, fut in futures.items():
                try:
                    ridx, trials, wall, resumed = fut.result()
                    outcomes[ridx] = (trials, wall, resumed)
                except Exception:
                    # the worker process died mid-shard (os._exit, OOM
                    # kill, segfault) — a dying process also breaks the
                    # pool, so *sibling* futures can land here too.
                    # Either way the recovery below is the same.
                    crashed.append(idx)

        # Crash recovery: every trial the dead worker synced to its
        # scratch file survives; only the unsynced tail is re-measured —
        # in-parent, since the broken pool can't take new work.
        for idx in crashed:
            scratch = TuningDB()
            path = self._scratch_path(idx)
            if path and os.path.exists(path):
                try:
                    scratch.merge(TuningDB(path))
                except (ValueError, OSError):
                    pass  # half-written scratch: re-measure everything
            done = dict(scratch.trials(bp))
            remaining = [
                p for p in shard_points[idx] if pp_key(p) not in done
            ]
            t0 = time.perf_counter()
            if remaining:
                _shard_search(
                    _space_from_points(remaining), cost, bp, layer,
                    scratch, 0, None, search=None,
                )
            trials = [
                (json.loads(k), float(c))
                for k, c in sorted(scratch.trials(bp).items())
            ]
            outcomes[idx] = (trials, time.perf_counter() - t0, len(done))

        reports: List[WorkerReport] = []
        scratches: List[TuningDB] = []
        for idx in range(len(shards)):
            trials, wall, resumed = outcomes[idx]
            scratch = TuningDB()
            best_point, best_cost = None, float("inf")
            for point, c in trials:
                scratch.record_trial(bp, point, c, layer)
                if c < best_cost:
                    best_point, best_cost = dict(point), float(c)
            scratches.append(scratch)
            reports.append(WorkerReport(
                worker=idx, points=len(shard_points[idx]),
                evaluations=len(trials) - resumed, wall_s=wall,
                best_point=best_point or {}, best_cost=best_cost,
                scratch_path=self._scratch_path(idx),
                resumed=resumed, crashed=idx in crashed,
            ))
        return reports, scratches


class FleetSearch(Search):
    """Adapter making a :class:`FleetCoordinator` a drop-in Search strategy.

    ``Tuner(search=coordinator.as_search())`` (or
    ``AutotunedOp(search=...)``) routes the before-execution sweep through
    the fleet: the Tuner still owns trial caching and the final
    ``record_best`` against *its* DB; the coordinator's merge barrier runs
    against the adapter's scratch target.  Thread backend only in this
    position — the Tuner's caching cost is a closure.
    """

    def __init__(
        self,
        coordinator: FleetCoordinator,
        bp: Optional[BasicParams] = None,
        db: Optional[TuningDB] = None,
        layer: str = "before_execution",
    ) -> None:
        self.coordinator = coordinator
        self.bp = bp
        self.db = db
        self.layer = layer

    def run(self, space: ParamSpace, cost) -> SearchResult:
        fleet = self.coordinator.search(
            space, cost, bp=self.bp, db=self.db, layer=self.layer
        )
        return fleet.result
