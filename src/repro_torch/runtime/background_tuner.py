"""Off-hot-path tuning orchestrator for serving traffic classes.

The paper tunes at install / before-execution time precisely so the run-time
layer never pays search cost.  A server cannot stop the world for
before-execution AT when an unseen traffic class arrives, so this module
moves that layer onto a worker thread:

1. the serve loop calls :meth:`BackgroundTuner.submit` for every batch — a
   shape-class/DB lookup only, **never** a cost evaluation;
2. an unseen class is enqueued once (deduplicated by BP fingerprint) and the
   caller keeps serving the region's safe precompiled default;
3. the worker pops the job, runs the op's search on the captured example
   arguments (:meth:`~repro_torch.core.autotuned.AutotunedOp.tune_state`), warms
   the top-k candidates, and the winner lands via ``region.select`` — the
   same set-on-entry/restore-on-exit switch the
   :class:`~repro_torch.core.tuner.RuntimeSelector` and
   :class:`~repro_torch.core.degree.DegreeController` use, so the hot swap is a
   dict-lookup away from the next request, with zero compilation.

The worker's search is the op's default path — the staged tuning pipeline:
a traffic class whose kernel already has a tuned sibling
class starts from that winner (a short refinement run instead of a full
sweep), and specs with a prescreen rank the space with the cheap
before-execution cost so only top-k survivors pay a measured evaluation.
:attr:`background_evaluations` counts the measured stage only;
:attr:`prescreen_evaluations` and :attr:`warm_started_labels` expose the
pipeline's bookkeeping for the operator and the throughput benchmark.

An optional ``on_complete`` callback lets the server mirror the tuned
degree into its :class:`~repro_torch.core.degree.DegreeController` (the
``omp_set_num_threads`` bookkeeping) the moment a winner lands.

The port of ``repro.runtime.background_tuner``, with its fleet hooks:
``fleet`` shards each search, ``service`` pulls a final before a search and
pushes the winner after it, and ``submit_retune`` runs the drift monitor's
re-tune.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..core.autotuned import AutotunedOp, OpState
from ..obs.trace import current_tracer


@dataclass
class TuneJob:
    op: AutotunedOp
    state: OpState
    args: tuple
    kwargs: dict
    label: str
    on_complete: Optional[Callable[[OpState], None]] = None
    # drift re-tune: run even though the class is tuned, fresh-measured,
    # unselected and unfinalized; the winner (or None on failure) goes to
    # ``on_winner`` — the DriftMonitor's canary entry.
    retune: bool = False
    on_winner: Optional[Callable[[Optional[dict]], None]] = None
    # enqueue stamp (time.perf_counter): the job span reports queue wait
    submitted_s: float = 0.0


class BackgroundTuner:
    """Worker thread + queue that runs before-execution AT off the hot path.

    ``fleet`` (optional): a :class:`~repro_torch.fleet.FleetCoordinator` —
    every queued search is then sharded across the coordinator's in-process
    workers with the merge barrier landing results in the op's DB (the
    spawn backend cannot sit here: the op's measured cost closes over live
    tensors).  On one card the workers time one at a time (the card's
    timing lock), so what the shards overlap is host work.

    ``service`` (optional): a :class:`~repro_torch.fleet.ServiceClient` on
    the global tuning service.  Before searching, the worker asks the
    service: an exact device-fingerprint **final** is adopted outright —
    merged into the op's DB and hot-swapped in with *zero* cost evaluations
    (:attr:`pulled_labels`); a **nearest** entry is merged so the op's
    warm-start machinery seeds the (shorter) refinement run.  After a
    successful local search the winner is pushed back.  All service traffic
    is ``try_*`` best-effort — a dead or partitioned service degrades this
    tuner to its local-only behaviour.
    """

    # the stop() sentinel must drain after every queued job regardless of
    # its priority, so it carries a key below any real submission
    _SENTINEL_KEY = 1 << 30

    def __init__(
        self,
        name: str = "repro-torch-background-tuner",
        fleet: Optional[Any] = None,
        service: Optional[Any] = None,
    ) -> None:
        self.name = name
        self.fleet = fleet
        self.service = service
        self.pulled_labels: List[str] = []  # finals adopted from the service
        # (-priority, seq, job): higher priority pops first, FIFO within a
        # priority level.  seq breaks ties before the (unorderable) job.
        self._queue: "queue.PriorityQueue[Tuple[int, int, Optional[TuneJob]]]" \
            = queue.PriorityQueue()
        self._seq = 0
        self._cv = threading.Condition()
        self._inflight: set = set()  # BP fingerprints queued or tuning now
        self._failed: Dict[str, str] = {}  # fp -> label, search raised
        self._quarantined: Dict[str, str] = {}  # fp -> label, candidates quarantined
        self._thread: Optional[threading.Thread] = None
        self.completed: List[Tuple[str, OpState]] = []
        self.errors: List[Tuple[str, BaseException]] = []

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "BackgroundTuner":
        with self._cv:  # two racing first-submits must not spawn two workers
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._worker, name=self.name, daemon=True
                )
                self._thread.start()
        return self

    def stop(self, timeout: Optional[float] = 10.0) -> None:
        with self._cv:
            thread = self._thread
        if thread is not None and thread.is_alive():
            self._put(None, self._SENTINEL_KEY)
            thread.join(timeout)
            if thread.is_alive():
                # still draining a long tune: keep the handle so a later
                # start() cannot spawn a second worker on the same queue
                return
        with self._cv:
            if self._thread is thread:
                self._thread = None

    def _put(self, job: Optional[TuneJob], key: int) -> None:
        with self._cv:
            self._seq += 1
            seq = self._seq
        self._queue.put((key, seq, job))

    def __enter__(self) -> "BackgroundTuner":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()

    # -- the serve-loop API --------------------------------------------------

    def submit(
        self,
        op: AutotunedOp,
        *args: Any,
        on_complete: Optional[Callable[[OpState], None]] = None,
        priority: int = 0,
        **kwargs: Any,
    ) -> OpState:
        """Resolve the call's shape class without tuning; queue tuning if new.

        Returns the state immediately — selected at the tuned winner when the
        DB already has one, at the safe default otherwise.  The caller's
        thread performs zero cost evaluations regardless of the op's ``tune``
        flag (``resolve_deferred`` never tunes).  A class whose search raised
        is not retried — it keeps serving the default and stays listed in
        :attr:`errors` / :attr:`failed_labels` for the operator.

        ``priority``: higher pops sooner (FIFO within a level).  The
        streaming engine submits scheduler-knob classes above kernel
        classes — a tuned scheduler reshapes every later batch, so it
        should win the queue.
        """
        self.start()
        state = op.resolve_deferred(*args, **kwargs)
        if state.tuned or state.from_cache:
            return state
        fp = state.bp.fingerprint()
        with self._cv:
            if fp in self._inflight or fp in self._failed:
                return state
            self._inflight.add(fp)
        label = state.traffic.label if state.traffic else op.spec.name
        self._put(TuneJob(op, state, args, kwargs, label, on_complete,
                          submitted_s=time.perf_counter()),
                  -priority)
        return state

    def submit_retune(
        self,
        op: AutotunedOp,
        state: OpState,
        args: tuple = (),
        kwargs: Optional[dict] = None,
        on_winner: Optional[Callable[[Optional[dict]], None]] = None,
    ) -> bool:
        """Queue a *fresh* re-measure of an already-tuned class.

        The DriftMonitor's off-hot-path re-tune: unlike :meth:`submit` this
        enqueues even though the class is tuned (that is the point — its
        winner drifted), clears any earlier failure mark (a re-tune is an
        explicit retry), and hands the challenger point to ``on_winner``
        instead of selecting it — the canary window decides the hot apply.
        Returns False when the class is already queued or tuning.
        """
        self.start()
        fp = state.bp.fingerprint()
        with self._cv:
            if fp in self._inflight:
                return False
            self._failed.pop(fp, None)
            self._inflight.add(fp)
        label = state.traffic.label if state.traffic else op.spec.name
        self._put(TuneJob(
            op, state, args, dict(kwargs or {}), label,
            retune=True, on_winner=on_winner,
            submitted_s=time.perf_counter(),
        ), 0)
        return True

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every queued class is tuned; False on timeout."""
        with self._cv:
            return self._cv.wait_for(lambda: not self._inflight, timeout)

    def cancel_pending(self, which: Optional[Callable[[str], bool]] = None) -> List[str]:
        """Drop every queued job the worker has not started (with ``which``,
        those whose label it accepts); returns their labels.  The job
        running now finishes.  A dropped class keeps serving its default
        and a later :meth:`submit` queues it again, so a bounded run can
        stop without tuning its whole backlog first (:meth:`stop` runs
        every queued job before it stops)."""
        dropped: List[str] = []
        kept = []
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            job = item[2]
            # a stop() sentinel stays queued, and a job ``which`` refuses
            if job is None or (which is not None and not which(job.label)):
                kept.append(item)
                continue
            dropped.append(job.label)
            with self._cv:
                self._inflight.discard(job.state.bp.fingerprint())
                self._cv.notify_all()
        for item in kept:
            self._queue.put(item)
        return dropped

    @property
    def pending(self) -> int:
        with self._cv:
            return len(self._inflight)

    @property
    def tuned_labels(self) -> List[str]:
        return [label for label, _ in self.completed]

    @property
    def failed_labels(self) -> List[str]:
        """Classes whose *search* failed — permanently serving the default.

        (:attr:`errors` can additionally hold ``on_complete`` callback
        exceptions; those classes are tuned and not listed here.)
        """
        with self._cv:
            return sorted(self._failed.values())

    @property
    def quarantined_labels(self) -> List[str]:
        """Classes whose search quarantined at least one candidate.

        The measurement guardrail (:meth:`~repro_torch.core.tuner.Tuner.tune`)
        marks candidates whose cost raised or came back non-finite; the
        class itself may still have tuned fine on the surviving points.
        Surfaced here (next to :attr:`failed_labels`) so the operator sees
        broken candidates even when the search as a whole succeeded.
        """
        with self._cv:
            return sorted(self._quarantined.values())

    @property
    def background_evaluations(self) -> int:
        """Measured cost evaluations this tuner ran — all off the hot path."""
        return sum(state.cost_evaluations for _, state in self.completed)

    @property
    def prescreen_evaluations(self) -> int:
        """Cheap stage-1 scores (analytic / compile-only, never executed)."""
        return sum(state.prescreen_evaluations for _, state in self.completed)

    @property
    def warm_started_labels(self) -> List[str]:
        """Classes tuned as warm-started refinements of a sibling's winner."""
        return [label for label, st in self.completed if st.warm_seed is not None]

    # -- worker --------------------------------------------------------------

    def _worker(self) -> None:
        while True:
            _, _, job = self._queue.get()
            if job is None:
                return
            tr = current_tracer()
            if tr is None:
                self._handle(job)
                continue
            wait = (
                time.perf_counter() - job.submitted_s
                if job.submitted_s else 0.0
            )
            # the queue->tune->swap lifecycle span: queue wait rides as an
            # attr, the tune itself nests the tuner.tune / search.* spans,
            # and the hot swap is stamped by the outcome
            with tr.span(
                "bgtuner.job", cat="bgtuner", label=job.label,
                retune=job.retune, queue_wait_s=round(max(0.0, wait), 6),
            ) as attrs:
                attrs["outcome"] = self._handle(job)

    def _handle(self, job: TuneJob) -> str:
        """Run one job through the queue->tune->swap lifecycle; returns the
        outcome label (``tuned`` / ``adopted`` / ``retuned`` / ``failed``)."""
        fp = job.state.bp.fingerprint()
        outcome = "tuned"
        try:
            if job.retune:
                self._run_retune(job)
                outcome = "retuned"
            elif self._adopt_from_service(job):
                outcome = "adopted"  # the service's final landed; no search
            else:
                job.op.tune_state(
                    job.state, job.args, job.kwargs,
                    search=self._fleet_search(job),
                )
                self._push_to_service(job, fp)
        except BaseException as e:  # a bad class must not kill the worker
            self.errors.append((job.label, e))
            outcome = "failed"
            with self._cv:  # never retried: submit() skips failed classes
                if not job.retune:
                    self._failed[fp] = job.label
        else:
            if not job.retune:
                tr = current_tracer()
                if tr is not None:  # the winner is live from this point on
                    tr.instant(
                        "bgtuner.swap", cat="bgtuner", label=job.label,
                        outcome=outcome,
                    )
                self.completed.append((job.label, job.state))
                if job.on_complete is not None:
                    try:  # a callback bug is an error, not a failed tune
                        job.on_complete(job.state)
                    except BaseException as e:
                        self.errors.append((job.label, e))
        finally:
            try:  # guardrail bookkeeping must not kill the worker either
                if job.op.db.quarantined(job.state.bp):
                    with self._cv:
                        self._quarantined[fp] = job.label
            except BaseException:
                pass
            with self._cv:
                self._inflight.discard(fp)
                self._cv.notify_all()
        return outcome

    def _fleet_search(self, job: TuneJob):
        """This job's search override: fleet-sharded when a coordinator is set."""
        if self.fleet is None:
            return None
        return self.fleet.as_search(bp=job.state.bp, db=job.op.db)

    def _adopt_from_service(self, job: TuneJob) -> bool:
        """Pull before tuning: adopt a device-matched final, seed from nearest.

        Returns True when the service supplied an exact final — merged
        into the op's DB and hot-swapped in with zero cost evaluations.
        A ``nearest`` entry is merged (a warm-start seed for the search
        this worker is about to run) and False returned; a degraded or
        absent service is just False.
        """
        if self.service is None:
            return False
        state = job.state
        resp = self.service.try_pull(state.bp)
        if resp is None or resp.get("found") is None:
            return False
        job.op.db.merge({resp["fingerprint"]: resp["entry"]})
        if resp["found"] != "final":
            return False  # nearest: the merged entry seeds the warm start
        tuned = job.op.db.tuned_point(
            state.bp,
            space_signature=getattr(state.region, "space_signature", None),
        )
        if tuned is None:
            # raced a local demotion, or the service final was searched
            # under a different emitted space: search normally
            return False
        # mirror _build_state's cache-hit path: select, mark, re-rank
        state.region.select(tuned)
        state.from_cache = True
        # fleet-adoption provenance for the explain report: this class is
        # running a winner another host searched, not a local result
        job.op.db.record_event(
            state.bp, "adopted_from_service",
            fingerprint=resp["fingerprint"], found=str(resp["found"]),
        )
        from ..core.tuner import RuntimeSelector

        state.selector = RuntimeSelector(
            state.region, state.bp, job.op.db,
            tolerance=job.op.tolerance, window=job.op.window,
        )
        self.pulled_labels.append(job.label)
        return True

    def _push_to_service(self, job: TuneJob, fp: str) -> None:
        """After a successful local search, publish the winner fleet-wide."""
        if self.service is not None:
            self.service.try_push(job.op.db, [fp])

    def _run_retune(self, job: TuneJob) -> None:
        winner: Optional[dict] = None
        try:
            winner = job.op.retune_state(job.state, job.args, job.kwargs)
        except BaseException as e:
            self.errors.append((job.label, e))
        if job.on_winner is not None:
            try:  # None signals a failed re-tune to the drift monitor
                job.on_winner(winner)
            except BaseException as e:
                self.errors.append((job.label, e))
