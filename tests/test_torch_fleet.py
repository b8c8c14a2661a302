"""The port's fleet against the JAX package's, on the CPU.

The same ``ParamSpace`` deals the same shards; the demo problem's fleet
winner, trials and evaluation count equal JAX's ``FleetCoordinator``'s for
every worker count and shard policy (thread, one spawn case, and a spawn
worker killed mid-shard that resumes from its scratch file); the device
fingerprint matches JAX's field for field on the host, and a device-keyed
port DB loads in ``repro.core.TuningDB`` with the same ``devices()``.  A
kernel's problem runs through the coordinator on plain versions, and a
fresh op recalls the fleet's final with 0 evaluations.
"""
from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.fleet as jfleet
import repro.fleet.workloads as jwork
import repro_torch.core as tcore
import repro_torch.fleet as tfleet
import repro_torch.fleet.workloads as twork
from test_torch_serve_common import restore_port_registry  # noqa: F401  (autouse)

PKGS = {"jax": (jcore, jfleet, jwork), "torch": (tcore, tfleet, twork)}


def _points(shards):
    return [[dict(p) for p in s.points()] for s in shards]


def _mixed_space(core):
    """A space with a constraint, so shards deal feasible points only."""
    return core.ParamSpace(
        [core.PerfParam("a", (1, 2, 4, 8)), core.PerfParam("b", ("x", "y", "z"))],
        constraint=lambda p: not (p["a"] == 8 and p["b"] == "z"),
    )


@pytest.mark.parametrize("policy", ["stride", "block"])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_shards_equal_jax(policy, n):
    for make in (lambda core, work: work.demo_space(), lambda core, work: _mixed_space(core)):
        jax_shards = make(jcore, jwork).shard(n, policy)
        torch_shards = make(tcore, twork).shard(n, policy)
        assert _points(torch_shards) == _points(jax_shards)


def _fleet_run(pkg, workers, policy, backend="thread", cost=None, **kw):
    core, fleet, work = PKGS[pkg]
    bp = core.BasicParams.make(kernel="fleet/demo")
    coord = fleet.FleetCoordinator(workers=workers, shard_policy=policy,
                                   backend=backend, sync_every=2, **kw)
    res = coord.search(work.demo_space(), cost or work.demo_cost, bp=bp)
    return res, bp


@pytest.mark.parametrize("policy", ["stride", "block"])
@pytest.mark.parametrize("workers", [1, 2, 3, 4])
def test_demo_fleet_winner_equals_jax(workers, policy):
    jres, jbp = _fleet_run("jax", workers, policy)
    tres, tbp = _fleet_run("torch", workers, policy)
    assert tres.best.point == jres.best.point == {"block": 64, "variant": "ij"}
    assert tres.best.cost == jres.best.cost
    assert tres.evaluations == jres.evaluations == twork.demo_space().size()
    assert [w.points for w in tres.workers] == [w.points for w in jres.workers]
    assert tres.merged.trials(tbp) == jres.merged.trials(jbp)
    assert tres.merged.tuned_point(tbp) == jres.merged.tuned_point(jbp)


def test_demo_fleet_spawn_equals_jax(tmp_path):
    jres, _ = _fleet_run("jax", 2, "stride", backend="spawn",
                         scratch_dir=str(tmp_path / "jax"))
    tres, _ = _fleet_run("torch", 2, "stride", backend="spawn",
                         scratch_dir=str(tmp_path / "torch"))
    assert tres.best.point == jres.best.point
    assert tres.best.cost == jres.best.cost
    assert tres.evaluations == jres.evaluations == twork.demo_space().size()
    assert not any(w.crashed for w in tres.workers)


def test_spawn_worker_crash_resumes_from_its_scratch_file(tmp_path, monkeypatch):
    """A spawn worker killed mid-shard: its synced trials survive in its
    scratch file, the coordinator measures only the rest, and the winner is
    still JAX's."""
    jres, _ = _fleet_run("jax", 2, "stride")
    shard0 = [dict(p) for p in twork.demo_space().shard(2, "stride")[0].points()]
    poison = shard0[5]  # after sync_every=2 has flushed four trials
    monkeypatch.setenv(twork.CRASH_POINT_ENV, json.dumps(poison))
    monkeypatch.setenv(twork.CRASH_ONCE_ENV, str(tmp_path / "crashed"))
    tres, _ = _fleet_run("torch", 2, "stride", backend="spawn",
                         cost=twork.crashing_demo_cost,
                         scratch_dir=str(tmp_path / "scratch"))
    assert (tmp_path / "crashed").exists()
    crashed = [w for w in tres.workers if w.crashed]
    assert crashed and crashed[0].resumed >= 4
    assert tres.best.point == jres.best.point
    assert tres.best.cost == jres.best.cost
    assert len(tres.result.trials) == twork.demo_space().size()


def test_fingerprint_matches_jax_on_the_host():
    jfp = jfleet.local_device()
    tfp = tfleet.local_device("cpu")
    assert tfp.bp_entries() == jfp.bp_entries()
    assert tfp.label == jfp.label
    assert tfleet.local_device("cpu") is tfp  # one detection per device
    assert tfp.arch_spec() is tcore.arch.CPU_HOST


def test_device_keyed_port_db_loads_in_jax(tmp_path):
    path = str(tmp_path / "db.json")
    costs = [3.0, 1.0, 2.0]
    op = tcore.AutotunedOp(_toy_spec(tcore, costs), db=tcore.TuningDB(path),
                           warm=False, device_key=True)
    state = op.resolve(torch.ones(4))
    assert state.bp["device_backend"] == "cpu"
    assert state.bp["device_platform"] == "cpu"
    port_devices = [d.label for d in tcore.TuningDB(path).devices()]
    jax_devices = [d.label for d in jcore.TuningDB(path).devices()]
    assert port_devices == jax_devices == [jfleet.local_device().label]
    # a fresh port op recalls the final with 0 evaluations, keyed the same
    fresh = tcore.AutotunedOp(_toy_spec(tcore, costs), db=tcore.TuningDB(path),
                              warm=False, device_key=True)
    again = fresh.resolve(torch.ones(4))
    assert again.from_cache and again.cost_evaluations == 0
    assert again.bp.fingerprint() == state.bp.fingerprint()


def test_device_key_env_and_foreign_device(monkeypatch):
    """``REPRO_DEVICE_KEY=1`` turns keying on; a final keyed to another
    device is not recalled, only warm-starts the search."""
    monkeypatch.setenv("REPRO_DEVICE_KEY", "1")
    costs = [3.0, 1.0, 2.0]
    db = tcore.TuningDB()
    op = tcore.AutotunedOp(_toy_spec(tcore, costs), db=db, warm=False)
    assert op.device_key
    bp = _toy_spec(tcore, costs).shape_class(torch.ones(4))
    foreign = tfleet.DeviceFingerprint(backend="gpu", platform="NVIDIA H100 80GB HBM3",
                                       device_count=1, host_cores=8, memory_gib=128,
                                       schema=2)
    db.record_best(bp.with_entries(**foreign.bp_entries()), {"i": 2}, 0.1, "before_execution")
    state = op.resolve(torch.ones(4))
    assert not state.from_cache and state.cost_evaluations > 0
    assert state.warm_seed == {"i": 2}
    assert db.tuned_point(state.bp) == {"i": 1}


def _toy_spec(core, costs, name="fleet_toy"):
    """A kernel with len(costs) candidates and scripted measured costs (the
    JAX package's ``tests/test_fleet.py`` toy, in either package)."""
    def make_region(bp):
        return core.ATRegion(
            name,
            core.ParamSpace([core.PerfParam("i", tuple(range(len(costs))))]),
            instantiate=lambda pt: (lambda x: x + pt["i"]),
        )

    def cost_factory(region, bp, args, kwargs):
        return lambda point: costs[point["i"]]

    return core.KernelSpec(
        name=name,
        make_region=make_region,
        shape_class=lambda x: core.BasicParams.make(kernel=name, n=int(x.shape[0])),
        cost_factory=cost_factory,
    )


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_background_tuner_fleet_sharded(pkg):
    """The BackgroundTuner's searches run through the coordinator: every
    point is measured once and the DB holds the fleet's final."""
    core, fleet, _ = PKGS[pkg]
    from importlib import import_module

    runtime = import_module("repro.runtime" if pkg == "jax" else "repro_torch.runtime")
    x = jnp.ones((4,)) if pkg == "jax" else torch.ones(4)
    costs = [3.0, 1.0, 2.0, 0.5, 4.0]
    db = core.TuningDB()
    op = core.AutotunedOp(_toy_spec(core, costs), db=db, warm=False, tune=False)
    coord = fleet.FleetCoordinator(workers=2, backend="thread")
    with runtime.BackgroundTuner(fleet=coord) as tuner:
        state = tuner.submit(op, x)
        assert tuner.drain(timeout=30)
    assert not tuner.errors
    assert db.tuned_point(state.bp) == {"i": 3}
    assert state.region.selected == {"i": 3}
    assert state.cost_evaluations == len(costs)


def test_example_args_have_jax_shapes():
    for name in twork.KERNELS:
        jargs = jwork.example_args(name)
        targs = twork.example_args(name, "cpu")
        jflat = [np.asarray(a) for a in _flat(jargs)]
        tflat = [a.numpy() for a in _flat(targs)]
        assert [(a.shape, str(a.dtype)) for a in tflat] == [
            (a.shape, str(a.dtype)) for a in jflat], name


def _flat(x):
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in _flat(x[k])]
    if isinstance(x, (list, tuple)):
        return [v for item in x for v in _flat(item)]
    return [x]


def test_kernel_problem_through_the_fleet_recalls_with_zero_evaluations():
    """exb on CPU tensors (the plain version, timed on the host clock):
    two workers measure every point once, the fleet's final is the argmin
    of the merged trials, and a fresh op on that DB recalls it."""
    from repro_torch.kernels.exb.ref import make_inputs

    args = (make_inputs(torch.Generator().manual_seed(0), dims=(2, 4, 8, 8), device="cpu"),)
    region, space, cost = twork.kernel_problem("exb", "cpu", args)
    spec = tcore.get_kernel("exb")
    bp = spec.shape_class(*args)
    db = tcore.TuningDB()
    fleet = tfleet.FleetCoordinator(workers=2, shard_policy="stride").search(
        space, cost, bp=bp, db=db, space_signature=region.space_signature)
    n = sum(1 for _ in space.points())
    assert fleet.evaluations == n == len(fleet.result.trials)
    trials = db.trials(bp)
    assert len(trials) == n
    assert fleet.best.point == json.loads(min(trials, key=lambda k: (trials[k], k)))
    assert db.tuned_point(bp, space_signature=region.space_signature) == fleet.best.point
    op = tcore.AutotunedOp(spec, db=db)
    state = op.resolve(*args)
    assert state.from_cache and state.cost_evaluations == 0
    assert state.region.selected == fleet.best.point
