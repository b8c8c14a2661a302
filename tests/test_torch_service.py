"""The port's tuning service against the JAX package's, on the CPU.

The same push / pull / demote sequence into either package's
``TuningService`` leaves the same DB JSON and answers the same; the same
seeded lossy transport fires the same faults and converges to the same
state; the remote fleet's union final equals JAX's; the port's
``BackgroundTuner`` adopts a service final with 0 evaluations and only
warm-starts from another device's; the anti-entropy loop carries a
fleet-wide re-tune into the drift lifecycle as JAX's does; and the service
answers over the stdlib HTTP transport on the loopback, metrics included.
"""
from __future__ import annotations

import json
from importlib import import_module

import jax.numpy as jnp
import pytest
import torch

from test_torch_fleet import PKGS, _toy_spec
from test_torch_serve_common import restore_port_registry  # noqa: F401  (autouse)


def _pkg(pkg):
    core, fleet, work = PKGS[pkg]
    runtime = import_module("repro.runtime" if pkg == "jax" else "repro_torch.runtime")
    x = jnp.ones((4,)) if pkg == "jax" else torch.ones(4)
    return core, fleet, work, runtime, x


def _client(fleet, service, **kw):
    clock = fleet.VirtualClock()
    kw.setdefault("retries", 3)
    return fleet.ServiceClient(fleet.InProcessTransport(service), sleep=clock.sleep,
                               now=clock.now, **kw)


def _db_with_final(core, bp, costs, point):
    db = core.TuningDB()
    for i, c in enumerate(costs):
        db.record_trial(bp, {"i": i}, c, "before_execution")
    db.record_best(bp, point, costs[point["i"]], "before_execution")
    return db


def _dump(db):
    return json.dumps(db.export_entries(), sort_keys=True, default=str)


def _service_sequence(pkg):
    """Push, pull, demote, a stale re-push, the re-tune's verdict and a
    second stale re-push; returns every answer and the service DB's JSON."""
    core, fleet, *_ = _pkg(pkg)
    bp = core.BasicParams.make(kernel="svc", n=4)
    other = core.BasicParams.make(kernel="svc", n=8)
    service = fleet.TuningService()
    a, b = _client(fleet, service), _client(fleet, service)
    answers = []
    host_a = _db_with_final(core, bp, [3.0, 1.0, 2.0], {"i": 1})
    answers.append(a.push(host_a))
    answers.append(b.push(_db_with_final(core, other, [0.5, 0.7], {"i": 0})))
    answers.append(b.pull(bp))
    answers.append(b.pull(core.BasicParams.make(kernel="svc", n=16)))
    answers.append(b.pull(core.BasicParams.make(kernel="elsewhere")))
    answers.append(b.demote(bp))
    answers.append(service.retune_pending())
    answers.append(a.push(host_a))  # stale final: knocked back down
    answers.append(service.db.tuned_point(bp))
    verdict = _db_with_final(core, bp, [3.0, 2.5, 2.0], {"i": 2})
    answers.append(b.push(verdict))  # a different final: request satisfied
    answers.append(service.retune_pending())
    answers.append(a.push(host_a))  # the guard restores the verdict
    answers.append(service.db.tuned_point(bp))
    synced = core.TuningDB()
    answers.append({k: v for k, v in b.sync(synced).items() if k != "entries"})
    return answers, _dump(service.db), _dump(synced), dict(service.stats)


def test_service_sequence_equals_jax():
    jax_answers, jax_db, jax_synced, jax_stats = _service_sequence("jax")
    port_answers, port_db, port_synced, port_stats = _service_sequence("torch")
    assert json.dumps(port_answers, sort_keys=True, default=str) == \
        json.dumps(jax_answers, sort_keys=True, default=str)
    assert port_db == jax_db
    assert port_synced == jax_synced == port_db
    assert port_stats == jax_stats
    assert port_answers[8] is None and port_answers[12] == {"i": 2}


def _lossy_pushes(pkg, seed):
    core, fleet, *_ = _pkg(pkg)
    service = fleet.TuningService()
    ft = fleet.FaultInjectionTransport(
        fleet.InProcessTransport(service), seed=seed, drop_request=0.2,
        drop_response=0.2, duplicate=0.3, reorder=0.2)
    clock = fleet.VirtualClock()
    client = fleet.ServiceClient(ft, retries=8, jitter_seed=seed, sleep=clock.sleep,
                                 now=clock.now)
    for n in range(6):
        bp = core.BasicParams.make(kernel="lossy", n=n)
        client.try_push(_db_with_final(core, bp, [1.0 + n, 0.5, 2.0], {"i": 1}))
    ft.heal()
    return _dump(service.db), vars(ft.stats), clock.sleeps


@pytest.mark.parametrize("seed", [1, 7, 42])
def test_lossy_transport_equals_jax(seed):
    jax_db, jax_stats, jax_sleeps = _lossy_pushes("jax", seed)
    port_db, port_stats, port_sleeps = _lossy_pushes("torch", seed)
    assert port_stats == jax_stats and port_stats["requests"] > 6  # faults fired
    assert port_sleeps == jax_sleeps
    assert port_db == jax_db


def _remote_fleet(pkg):
    core, fleet, work, *_ = _pkg(pkg)
    bp = core.BasicParams.make(kernel="remote_eq")
    service = fleet.TuningService()
    finals = []
    for host in range(2):
        ft = fleet.FaultInjectionTransport(
            fleet.InProcessTransport(service), seed=3 + host, drop_request=0.2,
            duplicate=0.2, reorder=0.1)
        clock = fleet.VirtualClock()
        client = fleet.ServiceClient(ft, retries=6, jitter_seed=host, sleep=clock.sleep,
                                     now=clock.now)
        res = fleet.FleetCoordinator(workers=2, backend="remote", service=client, hosts=2,
                                     host_index=host, sync_every=2).search(
            work.demo_space(), work.demo_cost, bp=bp)
        assert res.service_synced is True
        finals.append((res.best.point, res.best.cost, res.evaluations))
    return finals, _dump(service.db)


def test_two_host_remote_fleet_equals_jax():
    jax_finals, jax_db = _remote_fleet("jax")
    port_finals, port_db = _remote_fleet("torch")
    assert port_finals == jax_finals
    assert port_finals[-1][0] == {"block": 64, "variant": "ij"}  # the union's argmin
    assert port_db == jax_db


def test_background_tuner_adopts_a_service_final_with_zero_evaluations():
    core, fleet, _, runtime, x = _pkg("torch")
    service = fleet.TuningService()
    costs = [3.0, 1.0, 2.0]
    op_a = core.AutotunedOp(_toy_spec(core, costs), db=core.TuningDB(), warm=False,
                            device_key=True)
    state_a = op_a.resolve(x)
    _client(fleet, service).push(op_a.db, [state_a.bp.fingerprint()])

    op_b = core.AutotunedOp(_toy_spec(core, costs), db=core.TuningDB(), warm=False,
                            device_key=True)
    with runtime.BackgroundTuner(service=_client(fleet, service)) as tuner:
        state_b = tuner.submit(op_b, x)
        assert tuner.drain(timeout=60)
    assert not tuner.errors
    assert tuner.pulled_labels == ["fleet_toy"]
    assert state_b.from_cache and state_b.cost_evaluations == 0
    assert state_b.region.selected == {"i": 1}


def test_a_foreign_platforms_final_only_warm_starts():
    """A final keyed to another platform answers a pull as ``nearest``: the
    tuner merges it as a seed and searches, recalling nothing."""
    core, fleet, _, runtime, x = _pkg("torch")
    service = fleet.TuningService()
    costs = [3.0, 1.0, 2.0]
    bp = _toy_spec(core, costs).shape_class(x)
    foreign = fleet.DeviceFingerprint(backend="gpu", platform="NVIDIA A100-SXM4-80GB",
                                      device_count=1, host_cores=8, memory_gib=128, schema=2)
    fbp = bp.with_entries(**foreign.bp_entries())
    _client(fleet, service).push(_db_with_final(core, fbp, costs, {"i": 2}))

    op = core.AutotunedOp(_toy_spec(core, costs), db=core.TuningDB(), warm=False,
                          device_key=True)
    client = _client(fleet, service)
    with runtime.BackgroundTuner(service=client) as tuner:
        state = tuner.submit(op, x)
        assert tuner.drain(timeout=60)
    assert not tuner.errors
    assert tuner.pulled_labels == []
    assert client.stats.pulled_seeds == 1 and client.stats.pulled_finals == 0
    assert not state.from_cache and state.cost_evaluations > 0
    assert state.warm_seed == {"i": 2}
    assert op.db.tuned_point(state.bp) == {"i": 1}
    assert service.db.tuned_point(state.bp) == {"i": 1}  # pushed back after the search


def _fleet_wide_retune(pkg):
    """Host B demotes a shared final; host A's anti-entropy round carries
    the request into its drift monitor's lifecycle."""
    core, fleet, _, _, x = _pkg(pkg)
    service = fleet.TuningService()
    costs = {0: 1.0, 1: 0.5, 2: 2.0}
    op = core.AutotunedOp(_toy_spec(core, costs), db=core.TuningDB(), warm=False)
    state = op.resolve(x)
    host_a = _client(fleet, service)
    host_a.push(op.db)
    monitor = fleet.DriftMonitor(factor=2.0, min_observations=2, canary_window=2)
    sync = fleet.AntiEntropySync(host_a, op.db, monitor=monitor).watch(op)
    _client(fleet, service).demote(state.bp)
    costs.update({1: 2.0, 0: 0.3})
    first = sync.sync_once()
    outcomes = [monitor.observe(op, state, 0.3, (x,), {}) for _ in range(2)]
    sync.sync_once()
    kinds = [e["kind"] for e in op.db.events(state.bp)
             if e["kind"] in ("demoted", "retune_scheduled", "canary_start", "promoted",
                              "rolled_back")]
    return (first["retunes"], outcomes, [k for _, k in monitor.transitions], kinds,
            op.db.tuned_point(state.bp), service.retune_pending(), sync.rounds)


def test_anti_entropy_retune_equals_jax():
    jax_run = _fleet_wide_retune("jax")
    port_run = _fleet_wide_retune("torch")
    assert port_run == jax_run
    retunes, outcomes, transitions, kinds, final, pending, rounds = port_run
    assert retunes == 1 and outcomes[-1] == "promoted"
    assert kinds == ["demoted", "retune_scheduled", "canary_start", "promoted"]
    assert final == {"i": 0} and pending == {}


def test_the_service_over_http_on_the_loopback():
    from repro_torch.obs import parse_prometheus

    core, fleet, *_ = _pkg("torch")
    service = fleet.TuningService()
    try:
        server = fleet.serve_http(service, host="127.0.0.1", port=0)
    except OSError as e:  # a sandbox without a loopback bind
        pytest.skip(f"cannot bind a loopback port: {e}")
    host, port = server.server_address[:2]
    url = f"http://{host}:{port}"
    try:
        client = fleet.ServiceClient(fleet.HTTPTransport(url), retries=1)
        assert client.health()["ok"]
        bp = core.BasicParams.make(kernel="svc", n=4)
        client.push(_db_with_final(core, bp, [3.0, 1.0, 2.0], {"i": 1}))
        resp = client.pull(bp)
        assert resp["found"] == "final" and resp["entry"]["best"]["point"] == {"i": 1}
        with pytest.raises(fleet.ServiceUnavailable):  # a bad op, answered 500
            fleet.ServiceClient(fleet.HTTPTransport(url), retries=0)._call("nope", {})
        from urllib.request import urlopen

        with urlopen(f"{url}/metrics", timeout=5) as r:
            families = parse_prometheus(r.read().decode())
        assert families["tuning_service_push"][0][1] == 1.0
        assert families["tuning_db_finals"][0][1] == 1.0
    finally:
        server.shutdown()
        server.server_close()


def test_connection_refused_is_a_transport_error():
    _, fleet, *_ = _pkg("torch")
    with pytest.raises(fleet.TransportError):
        fleet.HTTPTransport("http://127.0.0.1:1", timeout_s=0.5).request("health", {})
