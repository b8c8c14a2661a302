"""The port engine's failure paths, and their parity with the JAX engine.

* chaos parity: ``adversarial_trace`` under ``ChaosInjector(seed=...)``
  (transient step faults, KV squeezes, virtual delays) with a
  ``TickTimer``, the port's engine against the JAX one: the results are
  identical rid for rid (status, tokens, detail) and so is what the
  injector did, which pins that the port calls the hooks in the JAX order;
* fault isolation: a decode or prefill step that raises after it wrote
  into its rows leaves the pool unchanged, and the retry gives the
  oracle's tokens; a poisoned request retires ``error`` alone;
* preemption with replay, ``KVPoolExhausted``, the watchdog, deadlines and
  the shed policies, as ``tests/test_engine_chaos.py`` checks them in the
  JAX package.
"""
from __future__ import annotations

import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data import adversarial_trace as jax_adversarial
from repro.obs import TickTimer as JaxTickTimer
from repro.runtime import ChaosInjector as JaxChaos
from repro.runtime import StreamingEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.data import ServingRequest, adversarial_trace, synthetic_requests
from repro_torch.obs import TickTimer
from repro_torch.runtime import (
    BlockAllocator, ChaosError, ChaosInjector, EngineStalled, KVPoolExhausted, PagedKVCache,
    Server, StreamingEngine,
)
from repro_torch.runtime import engine as engine_mod
from repro_torch.runtime.engine import REQUEST_STATUSES
from test_torch_serve_common import (  # noqa: F401 (the fixture is autouse)
    f32_weights, restore_port_registry,
)

ARCH = "tinyllama-1.1b"
SMOKE = get_config(ARCH, smoke=True)
MAX_LEN = 16


@pytest.fixture(scope="module")
def params():
    return f32_weights(ARCH)[1]


@pytest.fixture(scope="module")
def oracle_server(params):
    return Server(SMOKE, params, batch_size=1, max_len=MAX_LEN)


def _oracle(srv, reqs):
    out = {}
    for r in reqs:
        out.update(srv.run([ServingRequest(rid=r.rid, prompt=r.prompt,
                                           max_new_tokens=r.max_new_tokens)]))
    return out


def _drained(eng, reqs):
    """The drain contract every hardened serve must satisfy."""
    assert set(eng.results) == {r.rid for r in reqs}
    assert all(res.status in REQUEST_STATUSES for res in eng.results.values())
    assert eng.cache.free == eng.cache.n_blocks
    assert eng.cache.block_table == {}
    assert eng.hot_path_cost_evaluations == 0


CHAOS = dict(step_fault_rate=0.2, squeeze_rate=0.2, squeeze_hold=3, delay_rate=0.2,
             delay_s=0.01)


@pytest.mark.parametrize("arch,seed,queue_limit", [
    ("tinyllama-1.1b", 0, None), ("tinyllama-1.1b", 1, 1), ("tinyllama-1.1b", 2, None),
    ("falcon-mamba-7b", 3, 1),
])
def test_chaos_matches_the_jax_engine(arch, seed, queue_limit):
    cfg, jcfg = get_config(arch, smoke=True), jax_config(arch, smoke=True)
    jp, params = f32_weights(arch)
    kw = dict(seed=seed, scale=0.25, burst_size=4, burst_gap_s=0.02, deadline_ttl_s=0.03,
              malformed_rate=0.15, max_len_hint=24)
    trace = adversarial_trace(cfg, 12, **kw)
    engine_kw = dict(n_blocks=3, max_len=24, queue_limit=queue_limit)
    ours = StreamingEngine(cfg, params, chaos=ChaosInjector(seed=seed, **CHAOS),
                           timer=TickTimer(), **engine_kw)
    out = ours.serve(trace)
    theirs = JaxEngine(jcfg, jp, chaos=JaxChaos(seed=seed, **CHAOS), timer=JaxTickTimer(),
                       **engine_kw)
    ref = theirs.serve(jax_adversarial(jcfg, 12, **kw))
    _drained(ours, trace)
    assert out == ref
    assert {rid: (r.status, r.tokens, r.detail) for rid, r in ours.results.items()} == {
        rid: (r.status, r.tokens, r.detail) for rid, r in theirs.results.items()}
    assert ours.chaos.stats.as_metrics() == theirs.chaos.stats.as_metrics()
    assert ours.chaos.stats.faults > 0  # the chaos actually fired
    for key in ("timeouts", "sheds", "errors", "preempted", "step_faults", "decode_steps"):
        assert getattr(ours.stats, key) == getattr(theirs.stats, key), key


def _faulting(monkeypatch, name, fail_on):
    """Wrap the engine's ``name`` (``decode_fn`` or ``prefill_fn``): on its
    ``fail_on``-th call it runs to the end (writing into the rows it was
    given), then raises; every later call first records whether the pool
    still equals its snapshot from the failing call's start."""
    real = getattr(engine_mod, name)
    seen = {"calls": 0, "snapshot": None, "unchanged": []}

    def wrapped(*args, **kwargs):
        seen["calls"] += 1
        eng = seen["engine"]
        if seen["snapshot"] is not None and len(seen["unchanged"]) == 0:
            seen["unchanged"].append(all(
                torch.equal(eng.cache.pool[k], v) for k, v in seen["snapshot"].items()))
        if seen["calls"] == fail_on:
            seen["snapshot"] = {k: v.clone() for k, v in eng.cache.pool.items()}
            real(*args, **kwargs)
            raise RuntimeError(f"fault after the {name} step wrote its rows")
        return real(*args, **kwargs)

    monkeypatch.setattr(engine_mod, name, wrapped)
    return seen


@pytest.mark.parametrize("name,fail_on", [("decode_fn", 3), ("prefill_fn", 2)])
def test_a_step_that_raises_leaves_the_pool_unchanged(params, oracle_server, monkeypatch,
                                                      name, fail_on):
    reqs = synthetic_requests(SMOKE, 3, prompt_len=4, max_new_tokens=5)
    reqs[2].arrival_s = 1e-4  # a second prefill group
    ref = _oracle(oracle_server, reqs)
    seen = _faulting(monkeypatch, name, fail_on)
    eng = StreamingEngine(SMOKE, params, n_blocks=3, max_len=MAX_LEN)
    seen["engine"] = eng
    out = eng.serve(reqs)
    _drained(eng, reqs)
    assert seen["snapshot"] is not None and seen["unchanged"] == [True]
    assert eng.stats.step_faults == 1 and eng.stats.errors == 0
    assert out == ref  # the isolating retry started from the same pool


def test_poisoned_request_is_isolated(params, oracle_server):
    reqs = synthetic_requests(SMOKE, 3, prompt_len=4, max_new_tokens=4)
    ref = _oracle(oracle_server, reqs)
    eng = StreamingEngine(SMOKE, params, n_blocks=3, max_len=MAX_LEN,
                          chaos=ChaosInjector(seed=0, poison_rids=(1,)))
    out = eng.serve(reqs)
    _drained(eng, reqs)
    assert eng.results[1].status == "error" and "ChaosError" in eng.results[1].detail
    assert eng.stats.errors == 1 and eng.stats.step_faults >= 1
    assert out == {0: ref[0], 2: ref[2]}


def test_transient_faults_are_retried(params, oracle_server):
    reqs = synthetic_requests(SMOKE, 3, prompt_len=4, max_new_tokens=4)
    ref = _oracle(oracle_server, reqs)
    chaos = ChaosInjector(seed=3, step_fault_rate=0.3)
    eng = StreamingEngine(SMOKE, params, n_blocks=3, max_len=MAX_LEN, chaos=chaos)
    out = eng.serve(reqs)
    _drained(eng, reqs)
    assert chaos.stats.transient_faults >= 1 and eng.stats.step_faults >= 1
    for rid, toks in out.items():
        assert toks == ref[rid]


def test_unhardened_engine_crashes_under_chaos(params):
    reqs = synthetic_requests(SMOKE, 2, prompt_len=4, max_new_tokens=4)
    eng = StreamingEngine(SMOKE, params, n_blocks=2, max_len=MAX_LEN, hardened=False,
                          chaos=ChaosInjector(seed=0, poison_rids=(0,)))
    with pytest.raises(ChaosError):
        eng.serve(reqs)


def test_kv_pool_exhausted_is_typed():
    alloc = BlockAllocator(2)
    alloc.allocate()
    alloc.allocate()
    with pytest.raises(KVPoolExhausted) as ei:
        alloc.allocate()
    exc = ei.value
    assert isinstance(exc, RuntimeError)
    assert (exc.n_blocks, exc.in_use, exc.free) == (2, 2, 0)
    assert "allocator.free" in str(exc)


def test_cache_release_is_rid_idempotent():
    cache = PagedKVCache(SMOKE, n_blocks=2, capacity=8, device="cpu")
    cache.allocate(rid=7)
    assert cache.free == 1
    cache.release(7)
    cache.release(7)
    cache.release(99)
    assert cache.free == 2 and cache.block_table == {}
    alloc = BlockAllocator(1)
    b = alloc.allocate()
    alloc.release(b)
    with pytest.raises(ValueError):
        alloc.release(b)


def test_preemption_replays_the_evicted_trajectory(params, oracle_server):
    reqs = synthetic_requests(SMOKE, 2, prompt_len=4, max_new_tokens=6)
    reqs[1].arrival_s = 1e-4   # arrives while r0 is mid-decode
    reqs[1].priority = 1       # strictly higher: may evict r0
    ref = _oracle(oracle_server, reqs)
    eng = StreamingEngine(SMOKE, params, n_blocks=1, max_len=MAX_LEN)
    out = eng.serve(reqs)
    _drained(eng, reqs)
    assert eng.stats.preempted >= 1
    assert all(r.status == "ok" for r in eng.results.values())
    assert out == ref


def test_preemption_is_bounded(params):
    reqs = synthetic_requests(SMOKE, 3, prompt_len=4, max_new_tokens=6)
    for i, r in enumerate(reqs):
        r.arrival_s = i * 1e-4
        r.priority = i
    eng = StreamingEngine(SMOKE, params, n_blocks=1, max_len=MAX_LEN, max_preemptions=1)
    out = eng.serve(reqs)
    _drained(eng, reqs)
    assert all(r.status == "ok" for r in eng.results.values()) and len(out) == 3


def test_watchdog_fails_loudly_on_stall(params):
    reqs = synthetic_requests(SMOKE, 1, prompt_len=4, max_new_tokens=4)
    chaos = ChaosInjector(seed=0, squeeze_rate=1.0, squeeze_hold=10**9)
    eng = StreamingEngine(SMOKE, params, n_blocks=1, max_len=MAX_LEN, watchdog_limit=25,
                          chaos=chaos)
    with pytest.raises(EngineStalled) as ei:
        eng.serve(reqs)
    assert "waiting" in str(ei.value) and "free" in str(ei.value)


def test_deadline_retires_timed_out(params):
    reqs = synthetic_requests(SMOKE, 2, prompt_len=4, max_new_tokens=8)
    reqs[0].deadline_s = 1e-6
    eng = StreamingEngine(SMOKE, params, n_blocks=2, max_len=MAX_LEN)
    out = eng.serve(reqs)
    _drained(eng, reqs)
    assert eng.results[0].status == "timed_out" and eng.stats.timeouts == 1
    assert 0 not in out and len(eng.results[0].tokens) < 8
    assert eng.results[1].status == "ok" and len(out[1]) == 8


def test_default_ttl(params):
    reqs = synthetic_requests(SMOKE, 3, prompt_len=4, max_new_tokens=8)
    eng = StreamingEngine(SMOKE, params, n_blocks=2, max_len=MAX_LEN, default_ttl_s=1e-6)
    assert eng.serve(reqs) == {}
    _drained(eng, reqs)
    assert eng.stats.timeouts == 3


def _shed_trace(n=6):
    reqs = synthetic_requests(SMOKE, n, prompt_len=4, max_new_tokens=4)
    for r in reqs:
        r.arrival_s = 0.0
    return reqs


@pytest.mark.parametrize("policy", ["reject-new", "drop-oldest", "deadline-aware"])
def test_shed_policies_drain(params, policy):
    reqs = _shed_trace()
    if policy == "deadline-aware":
        reqs[2].deadline_s = 10.0
    eng = StreamingEngine(SMOKE, params, n_blocks=1, max_len=MAX_LEN, queue_limit=2,
                          shed_policy=policy)
    eng.serve(reqs)
    _drained(eng, reqs)
    shed = sorted(r.rid for r in eng.results.values() if r.status == "shed")
    assert len(shed) >= 1 and eng.stats.sheds == len(shed)
    assert all(eng.results[rid].tokens == [] for rid in shed)
    if policy == "drop-oldest":
        assert shed[0] < max(r.rid for r in eng.results.values() if r.status == "ok")
    if policy == "deadline-aware":
        assert 2 in shed


def test_malformed_requests_retire_error(params):
    trace = adversarial_trace(SMOKE, 8, seed=11, scale=0.1, deadline_fraction=0.0,
                              malformed_rate=0.5, max_len_hint=MAX_LEN)
    malformed = {r.rid for r in trace if len(r.prompt) == 0 or r.max_new_tokens < 1
                 or len(r.prompt) + r.max_new_tokens > MAX_LEN}
    assert malformed and len(malformed) < len(trace)
    eng = StreamingEngine(SMOKE, params, n_blocks=2, max_len=MAX_LEN)
    out = eng.serve(trace)
    _drained(eng, trace)
    for rid in malformed:
        assert eng.results[rid].status == "error" and "malformed" in eng.results[rid].detail
    assert set(out) == {r.rid for r in trace} - malformed
