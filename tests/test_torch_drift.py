"""The port's drift watch against the JAX package's, on the CPU.

On the toy kernel of the JAX package's ``tests/test_fleet.py`` the same
observations give the same transitions, events and finals in both packages
(promote, roll back, a fleet-wide request, and the re-tune that measures
again rather than replaying its cache); the re-tune also runs on the
port's BackgroundTuner; and a monitored ``AutotunedOp`` feeds the watch
its sampled calls' times: a healthy run makes no transition, a slowed
winner is demoted, re-tuned and replaced.
"""
from __future__ import annotations

import math
import threading
import time

import pytest
import torch

import repro_torch.core as tcore
from repro_torch.fleet import DriftMonitor
from repro_torch.runtime import BackgroundTuner
from test_torch_fleet import _toy_spec
from test_torch_service import _pkg
from test_torch_serve_common import restore_port_registry  # noqa: F401  (autouse)

LIFECYCLE = ("demoted", "retune_scheduled", "canary_start", "promoted", "rolled_back",
             "retune_failed")


def _kinds(db, bp):
    return [e["kind"] for e in db.events(bp) if e["kind"] in LIFECYCLE]


def _scripted(pkg, canary_cost, calls=None):
    """Tune the toy, slow its winner, feed the watch, then ``canary_cost``
    for the challenger's canary window and what the verdict's pick
    delivers after it."""
    core, fleet, _, _, x = _pkg(pkg)
    costs = {0: 1.0, 1: 0.5, 2: 2.0}

    def counted(point):
        if calls is not None:
            calls.append((pkg, dict(point)))
        return costs[point["i"]]

    spec = _toy_spec(core, costs)
    spec = core.KernelSpec(name=spec.name, make_region=spec.make_region,
                           shape_class=spec.shape_class,
                           cost_factory=lambda *a: counted)
    db = core.TuningDB()
    op = core.AutotunedOp(spec, db=db, warm=False)
    state = op.resolve(x)
    monitor = fleet.DriftMonitor(factor=2.0, min_observations=4, canary_window=3)
    costs.update({1: 2.0, 0: 0.3})
    outcomes = [monitor.observe(op, state, 2.0, (x,), {}) for _ in range(4)]
    selected_in_canary = dict(state.region.selected)
    outcomes += [monitor.observe(op, state, canary_cost, (x,), {}) for _ in range(3)]
    live = min(canary_cost, 2.0)  # what the class delivers after the verdict
    outcomes += [monitor.observe(op, state, live, (x,), {}) for _ in range(8)]
    return (outcomes, [k for _, k in monitor.transitions], _kinds(db, state.bp),
            selected_in_canary, dict(state.region.selected), db.tuned_point(state.bp),
            db.best_cost(state.bp))


@pytest.mark.parametrize("canary_cost, verdict", [(0.3, "promoted"), (9.0, "rolled_back")])
def test_lifecycle_equals_jax(canary_cost, verdict):
    jax_run = _scripted("jax", canary_cost)
    port_run = _scripted("torch", canary_cost)
    assert port_run == jax_run
    outcomes, transitions, kinds, canary, selected, final, cost = port_run
    assert outcomes[3] == "demoted" and outcomes[6] == verdict
    assert outcomes.count(None) == len(outcomes) - 2  # re-armed, not flapping
    assert transitions == kinds == ["demoted", "retune_scheduled", "canary_start", verdict]
    assert canary == {"i": 0}
    if verdict == "promoted":
        assert selected == final == {"i": 0} and cost == pytest.approx(0.3)
    else:  # the incumbent is back, re-finalized at what it delivered
        assert selected == final == {"i": 1} and cost == pytest.approx(2.0)


def test_the_retune_measures_again_in_both_packages():
    calls = []
    _scripted("jax", 0.3, calls)
    _scripted("torch", 0.3, calls)
    for pkg in ("jax", "torch"):
        points = [p for k, p in calls if k == pkg]
        assert len(points) == 6  # three at the tune, all three again at the re-tune
    assert [p for k, p in calls if k == "jax"] == [p for k, p in calls if k == "torch"]


def test_the_retune_runs_on_the_background_tuner():
    core, fleet, _, _, x = _pkg("torch")
    costs = {0: 1.0, 1: 0.5, 2: 2.0}
    db = core.TuningDB()
    op = core.AutotunedOp(_toy_spec(core, costs), db=db, warm=False)
    state = op.resolve(x)
    with BackgroundTuner() as tuner:
        monitor = DriftMonitor(background=tuner, factor=2.0, min_observations=4,
                               canary_window=2)
        costs.update({1: 2.0, 0: 0.3})
        for _ in range(4):
            monitor.observe(op, state, 2.0, (x,), {})
        deadline = time.time() + 30
        while monitor.watch_phase(state) != "canary":
            assert time.time() < deadline, "the background re-tune never landed"
            time.sleep(0.01)
        outcomes = [monitor.observe(op, state, 0.3, (x,), {}) for _ in range(2)]
    assert not tuner.errors
    assert outcomes[-1] == "promoted"
    assert _kinds(db, state.bp) == ["demoted", "retune_scheduled", "canary_start", "promoted"]
    (scheduled,) = [e for e in db.events(state.bp) if e["kind"] == "retune_scheduled"]
    assert scheduled["mode"] == "background"


DELAYS = {0: 0.010, 1: 0.020, 2: 0.030}  # seconds a candidate sleeps


def _sleeper_spec(delays):
    """Candidate ``i`` sleeps ``delays[i]`` seconds: the op's own measured
    cost (the host clock on CPU tensors) sees what the test sets."""
    def make_region(bp):
        def instantiate(pt):
            def run(x):
                time.sleep(delays[pt["i"]])
                return x + pt["i"]
            return run
        return tcore.ATRegion("sleeper", tcore.ParamSpace(
            [tcore.PerfParam("i", tuple(sorted(delays)))]), instantiate)

    return tcore.KernelSpec(
        name="drift_sleeper", make_region=make_region,
        shape_class=lambda x: tcore.BasicParams.make(kernel="drift_sleeper",
                                                     n=int(x.shape[0])))


def test_monitored_calls_feed_the_watch():
    delays = dict(DELAYS)
    monitor = DriftMonitor(factor=2.0)
    # the straggler selector keeps out of the way (it switches on its own
    # rule), so the transitions are the watch's alone
    op = tcore.AutotunedOp(_sleeper_spec(delays), db=tcore.TuningDB(), monitor_every=1,
                           tolerance=math.inf, drift=monitor)
    x = torch.ones(4)
    for _ in range(24):
        op(x)
    (state,) = op.states().values()
    assert state.region.selected == {"i": 0}
    assert monitor.transitions == []  # healthy: observed ~ recorded
    assert monitor.checks > 0  # ...against a recorded final
    evaluations = state.cost_evaluations
    # the winner slows past factor x its recorded cost, far enough that the
    # EWMA it is demoted at stays clear of the challenger under host noise
    delays[0] = 0.100
    for _ in range(16):
        op(x)
    assert [k for _, k in monitor.transitions] == [
        "demoted", "retune_scheduled", "canary_start", "promoted"]
    assert state.cost_evaluations > evaluations  # measured again, not replayed
    assert state.region.selected == {"i": 1}
    assert op.db.tuned_point(state.bp) == {"i": 1}


class _Counting(DriftMonitor):
    """Counts what it is fed, and keeps each class's last call args."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.seen = 0
        self.calls = {}

    def observe(self, op, state, cost, args=(), kwargs=None):
        self.seen += 1
        self.calls[state.bp.fingerprint()] = (op, state, args)
        return super().observe(op, state, cost, args, kwargs)


def _cpu_server(**kw):
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.runtime import Server

    cfg = get_config("tinyllama-1.1b", smoke=True)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return cfg, Server(cfg, params, batch_size=2, **kw)


@pytest.mark.parametrize("trial_running", [False, True])
def test_the_server_watches_drift_between_trials(trial_running):
    """The Server feeds its step times to the drift watch, but not a step
    that a timed window of the card's timing lock overlapped: a trial's
    kernels ran beside it."""
    from repro_torch.data import synthetic_requests

    monitor = _Counting(factor=2.0)
    cfg, server = _cpu_server(inline_tune=True, drift_monitor=monitor)
    lock = tcore.cost.timing_lock("cpu")
    held, done = threading.Event(), threading.Event()

    def trial():  # a trial that holds its window over the whole run
        with lock:
            held.set()
            done.wait(60)

    holder = threading.Thread(target=trial, daemon=True)
    if trial_running:
        holder.start()
        assert held.wait(10)
    try:
        server.run(synthetic_requests(cfg, 4, 4, 3))
    finally:
        done.set()
        if trial_running:
            holder.join(10)
    # two groups of one class, each a decode observation, and the second
    # group's prefill (a class's first prefill pays what a process pays once)
    assert monitor.seen == (0 if trial_running else 3)
    assert monitor.transitions == []


def test_a_canary_completes_while_other_classes_stay_queued():
    """A class queued or tuning on the background tuner does not hold up
    the watch: a served class's canary fills and reaches its verdict while
    the tuner works on another class with a third queued behind it."""
    from repro_torch.data import synthetic_requests

    with BackgroundTuner() as tuner:
        monitor = _Counting(background=tuner, factor=2.0, canary_window=2)
        cfg, server = _cpu_server(background_tuner=tuner, drift_monitor=monitor)
        requests = synthetic_requests(cfg, 4, 4, 3)
        server.run(requests)
        assert tuner.drain(60) and not tuner.errors
        prefill = [c for c in monitor.calls.values() if c[0] is server.prefill_op]
        op, state, args = prefill[-1]
        assert op.db.tuned_point(state.bp) is not None

        release = threading.Event()

        def blocking_cost(region, bp, a, k):
            return lambda point: 1.0 + point["i"] if release.wait(60) else math.inf

        spec = _toy_spec(tcore, {0: 1.0, 1: 2.0}, name="drift_blocker")
        blocker = tcore.AutotunedOp(tcore.KernelSpec(
            name=spec.name, make_region=spec.make_region, shape_class=spec.shape_class,
            cost_factory=blocking_cost), db=tcore.TuningDB(), warm=False)
        try:
            assert monitor.request_retune(op, state, args)
            tuner.submit(blocker, torch.ones(2))  # tunes once the re-tune is done
            tuner.submit(blocker, torch.ones(3))  # queued behind it
            deadline = time.time() + 60
            while monitor.watch_phase(state) != "canary":
                assert time.time() < deadline, "the background re-tune never landed"
                time.sleep(0.01)
            server.run(requests)
            kinds = [k for _, k in monitor.transitions]
            assert tuner.pending >= 2  # the two blocker classes, not tuned yet
        finally:
            release.set()
    assert not tuner.errors
    assert kinds[:3] == ["demoted", "retune_scheduled", "canary_start"]
    assert kinds[3] in ("promoted", "rolled_back")
    assert monitor.watch_phase(state) == "healthy"
