"""The port's static ``Server`` against the JAX package's, and its tuning rules.

* parity: on the float32 SMOKE config of one arch per family, both
  servers run the same mixed trace at batch 2, pinned to each degree of the
  domain; the greedy tokens are equal, and so are the prefill and decode
  counts (the JAX outputs are computed once per arch, a module fixture);
* the decode count and tail-batch contracts of
  ``tests/test_serve_engine.py``;
* tuning: with a ``BackgroundTuner`` the hot path pays 0 evaluations,
  serve ops and the kernel ops the model calls alike (a fake kernel op
  registered on the CPU stands in for flash, so the nested path runs);
  with ``inline_tune`` it pays them; with neither, nothing is tuned;
* ``joint_tune`` returns, and a second server on the same DB recalls the
  joint winner with 0 evaluations.
"""
from __future__ import annotations

import threading
import unittest.mock as mock

import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data import mixed_traffic_trace as jax_trace
from repro.runtime import Server as JaxServer
from repro_torch.configs import get_config
from repro_torch.core import ATRegion, BasicParams, KernelSpec, ParamSpace, PerfParam
from repro_torch.core import AutotunedOp, TuningDB, register_kernel
from repro_torch.data import mixed_traffic_trace, synthetic_requests
from repro_torch.models import attention, transformer
from repro_torch.models.route import run_kernel
from repro_torch.runtime import BackgroundTuner, Server
from test_torch_serve_common import (  # noqa: F401 (the fixture is autouse)
    FAMILIES, f32_weights, jax_run_mode, restore_port_registry,
)

BATCH = 2
MAX_LEN = 40
N_REQUESTS = {"whisper-large-v3": 2}  # op by op on the JAX side: fewer


def _trace(module, cfg, arch):
    return module(cfg, N_REQUESTS.get(arch, 4), seed=1, scale=0.25)


def _pin(server, degree: int) -> None:
    """Serve only ``degree``: both packages build each op's region from
    ``_degree_space`` when a class is first resolved."""
    space = ParamSpace([PerfParam("degree", (degree,))])
    server._degree_space = lambda: space


def _domain(arch):
    return (1,) if get_config(arch, smoke=True).family == "moe" else (1, 2)


@pytest.fixture(scope="module")
def jax_runs():
    """arch -> {degree: (tokens, prefill calls, decode calls)} of the JAX
    Server, computed on first use."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jp, _ = f32_weights(arch)
            cfg = jax_config(arch, smoke=True)
            cache[arch] = {}
            for d in _domain(arch):
                srv = JaxServer(cfg, jp, batch_size=BATCH, max_len=MAX_LEN)
                _pin(srv, d)
                with jax_run_mode(arch):
                    out = srv.run(_trace(jax_trace, cfg, arch))
                cache[arch][d] = (out, srv.stats.prefill_calls, srv.stats.decode_calls)
        return cache[arch]

    return get


@pytest.mark.parametrize("arch", FAMILIES)
def test_server_matches_the_jax_server_at_every_degree(arch, jax_runs):
    cfg = get_config(arch, smoke=True)
    _, params = f32_weights(arch)
    ref = jax_runs(arch)
    for d in _domain(arch):
        srv = Server(cfg, params, batch_size=BATCH, max_len=MAX_LEN)
        _pin(srv, d)
        out = srv.run(_trace(mixed_traffic_trace, cfg, arch))
        want, prefills, decodes = ref[d]
        assert out == want, (arch, d)
        assert (srv.stats.prefill_calls, srv.stats.decode_calls) == (prefills, decodes)
        assert srv.stats.prefill_calls % d == 0
        assert srv.hot_path_cost_evaluations == 0


def test_server_exact_decode_count_and_tokens():
    cfg = get_config("tinyllama-1.1b", smoke=True)
    _, params = f32_weights("tinyllama-1.1b")
    reqs = synthetic_requests(cfg, 5, prompt_len=4, max_new_tokens=3)
    for r, mnt in zip(reqs, (3, 1, 2, 3, 2)):
        r.max_new_tokens = mnt
    srv = Server(cfg, params, batch_size=2, max_len=16)
    out = srv.run(reqs)
    # groups (3,1) (2,3) (2): the prefill yields token 1, decodes cover the
    # rest of the group max: (3-1) + (3-1) + (2-1) at degree 1
    assert srv.stats.prefill_calls == 3
    assert srv.stats.decode_calls == 5
    assert srv.stats.tokens_out == sum(r.max_new_tokens for r in reqs)
    for r in reqs:
        assert len(out[r.rid]) == r.max_new_tokens


def test_server_tail_batch_matches_sequential():
    cfg = get_config("tinyllama-1.1b", smoke=True)
    _, params = f32_weights("tinyllama-1.1b")
    reqs = synthetic_requests(cfg, 5, prompt_len=6, max_new_tokens=4)
    for r, mnt in zip(reqs, (4, 1, 3, 2, 4)):
        r.max_new_tokens = mnt
    oracle = Server(cfg, params, batch_size=1, max_len=16)
    ref = {}
    for r in reqs:
        ref.update(oracle.run([r]))
    assert Server(cfg, params, batch_size=2, max_len=16).run(reqs) == ref


def test_server_rejects_malformed_and_duplicate_requests():
    cfg = get_config("tinyllama-1.1b", smoke=True)
    _, params = f32_weights("tinyllama-1.1b")
    srv = Server(cfg, params, batch_size=2, max_len=16)
    reqs = synthetic_requests(cfg, 2, prompt_len=4, max_new_tokens=2)
    reqs[1].rid = reqs[0].rid
    with pytest.raises(ValueError, match="duplicate"):
        srv.run(reqs)
    reqs = synthetic_requests(cfg, 1, prompt_len=4, max_new_tokens=0)
    with pytest.raises(ValueError, match="max_new_tokens"):
        srv.run(reqs)


FAKE = "fake_flash_serving"


def _register_fake_kernel():
    """A kernel op of two points on CPU tensors, both the plain causal
    attention: the model's attention calls it through ``run_kernel``, as
    it calls ``flash_attention`` on the card."""

    def instantiate(point):
        return lambda q, k, v: attention.full_attention(q, k, v, causal=True)

    register_kernel(KernelSpec(
        name=FAKE,
        make_region=lambda bp: ATRegion(FAKE, ParamSpace([PerfParam("block", (1, 2))]),
                                        instantiate),
        shape_class=lambda q, k, v: BasicParams.make(
            kernel=FAKE, q=tuple(q.shape), kv=tuple(k.shape), dtype=str(q.dtype)),
        tags=("test",),
    ), replace=True)


@pytest.fixture
def fake_kernel(monkeypatch):
    """Route the models' causal attention through the fake kernel op."""
    _register_fake_kernel()
    calls = []

    def routed(q, k, v):
        calls.append(q.shape)
        return run_kernel(FAKE, q, k, v)

    monkeypatch.setattr(transformer, "causal_attention", routed)
    return calls


def _serve(background=None, inline_tune=False, db=None):
    cfg = get_config("tinyllama-1.1b", smoke=True)
    _, params = f32_weights("tinyllama-1.1b")
    srv = Server(cfg, params, batch_size=2, max_len=40, tuning_db=db or TuningDB(),
                 background_tuner=background, inline_tune=inline_tune)
    srv.run(mixed_traffic_trace(cfg, 4, seed=0, scale=0.25))
    return srv


def _kernel_states(srv):
    return [st for st in srv.rule.states().values() if st.bp["kernel"] == FAKE]


def test_background_tuning_keeps_the_hot_path_at_zero(fake_kernel):
    tuner = BackgroundTuner()
    try:
        srv = _serve(background=tuner)
        assert fake_kernel  # the nested kernel path ran
        assert srv.hot_path_cost_evaluations == 0
        assert tuner.drain(timeout=120)
    finally:
        tuner.stop()
    assert not tuner.errors
    labels = set(tuner.tuned_labels)
    assert any(label.startswith("prefill/") for label in labels)
    assert FAKE in labels  # the kernel classes went to the worker too
    kernels = _kernel_states(srv)
    assert kernels and all(st.tuned for st in kernels)
    assert sum(st.cost_evaluations for st in kernels) > 0
    assert srv.hot_path_cost_evaluations == 0  # the worker's evaluations


@pytest.mark.parametrize("inline_tune", [False, True])
def test_engine_keeps_tuning_off_the_hot_path_unless_inline(fake_kernel, inline_tune):
    """The engine's rule as the Server's: a BackgroundTuner takes every
    class, its scheduler's and the nested kernel's; inline tuning pays
    on the hot path."""
    from repro_torch.data import bursty_open_loop_trace
    from repro_torch.runtime import StreamingEngine

    cfg = get_config("tinyllama-1.1b", smoke=True)
    _, params = f32_weights("tinyllama-1.1b")
    reqs = bursty_open_loop_trace(cfg, 4, seed=0, scale=0.25)
    max_len = max(len(r.prompt) + r.max_new_tokens for r in reqs)
    tuner = None if inline_tune else BackgroundTuner()
    try:
        eng = StreamingEngine(cfg, params, n_blocks=2, max_len=max_len,
                              background_tuner=tuner, inline_tune=inline_tune)
        eng.serve(reqs)
        assert fake_kernel
        if tuner is not None:
            assert eng.hot_path_cost_evaluations == 0
            assert tuner.drain(timeout=120) and not tuner.errors
    finally:
        if tuner is not None:
            tuner.stop()
    kernel_evals = sum(st.cost_evaluations for st in eng.rule.states().values())
    assert kernel_evals > 0
    if inline_tune:
        assert eng.rule.hot_path_cost_evaluations == kernel_evals
        assert eng.hot_path_cost_evaluations > kernel_evals
    else:
        assert eng.hot_path_cost_evaluations == 0
        assert FAKE in tuner.tuned_labels and eng.tuned_scheduler_classes


def test_inline_tuning_pays_on_the_hot_path(fake_kernel):
    srv = _serve(inline_tune=True)
    kernels = _kernel_states(srv)
    kernel_evals = sum(st.cost_evaluations for st in kernels)
    assert kernel_evals > 0
    assert srv.rule.hot_path_cost_evaluations == kernel_evals
    assert srv.hot_path_cost_evaluations > kernel_evals  # the serve ops' too


def test_without_a_tuner_nothing_tunes(fake_kernel):
    srv = _serve()
    assert srv.hot_path_cost_evaluations == 0
    kernels = _kernel_states(srv)
    assert kernels and not any(st.tuned or st.from_cache for st in kernels)
    assert all(st.region.selected == {"block": 1} for st in kernels)  # the default
    for op in (srv.prefill_op, srv.decode_op):
        assert not any(st.tuned for st in op.states().values())


def test_a_second_pass_on_the_same_db_recalls_everything(fake_kernel):
    db = TuningDB()
    tuner = BackgroundTuner()
    try:
        _serve(background=tuner, db=db)
        assert tuner.drain(timeout=120)
        evaluations = tuner.background_evaluations
        again = _serve(background=tuner, db=db)
        assert tuner.drain(timeout=120)
    finally:
        tuner.stop()
    assert tuner.background_evaluations == evaluations  # no new work
    states = [st for op in (again.prefill_op, again.decode_op)
              for st in op.states().values()] + list(again.rule.states().values())
    assert states and all(st.from_cache and st.cost_evaluations == 0 for st in states)


def test_joint_tune_then_recall():
    cfg = get_config("tinyllama-1.1b", smoke=True)
    _, params = f32_weights("tinyllama-1.1b")
    db = TuningDB()
    reqs = synthetic_requests(cfg, 2, prompt_len=5, max_new_tokens=3)
    first = Server(cfg, params, batch_size=2, max_len=16, tuning_db=db).joint_tune(
        reqs, decode_steps=2)
    assert first.evaluations > 0 and not first.from_cache
    assert set(first.assignment) == {"prefill", "decode"}
    second = Server(cfg, params, batch_size=2, max_len=16, tuning_db=db)
    again = second.joint_tune(reqs, decode_steps=2)
    assert again.from_cache and again.evaluations == 0
    assert again.assignment == first.assignment
    # the recalled winner serves, and serves the same tokens as degree 1
    assert second.run(reqs) == Server(cfg, params, batch_size=2, max_len=16).run(reqs)


def test_chunked_decode_steps_a_copy_of_the_cache():
    """The decode op is functional: a candidate (or a background trial on
    the captured arguments) never writes the cache it was given; degree 2
    gives degree 1's logits within the JAX test's rtol = atol = 1e-5 (a
    batch-1 GEMM may round differently from a batch-2 one) and its tokens."""
    cfg = get_config("recurrentgemma-2b", smoke=True)
    _, params = f32_weights("recurrentgemma-2b")
    srv = Server(cfg, params, batch_size=2, max_len=40)
    reqs = synthetic_requests(cfg, 2, prompt_len=20, max_new_tokens=2)
    batch = srv._batch_inputs(reqs, 20)
    state = srv.prefill_op.resolve(srv.params, batch)
    logits, cache = state.region.candidate({"degree": 2})(srv.params, batch)
    l1, _ = state.region.candidate({"degree": 1})(srv.params, batch)
    torch.testing.assert_close(logits, l1, rtol=1e-5, atol=1e-5)
    before = {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in cache.items()}
    tok = logits.argmax(-1).to(torch.int32)
    dbatch = {"tokens": tok[:, None]}
    dstate = srv.decode_op.resolve(srv.params, dbatch, cache)
    d1, n1 = dstate.region.candidate({"degree": 1})(srv.params, dbatch, cache)
    d2, n2 = dstate.region.candidate({"degree": 2})(srv.params, dbatch, cache)
    torch.testing.assert_close(d1, d2, rtol=1e-5, atol=1e-5)
    assert torch.equal(d1.argmax(-1), d2.argmax(-1))
    for k, v in before.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(cache[k], v), k
            assert n1[k].shape == n2[k].shape == v.shape, k
    assert cache["len"] == 20 and n1["len"] == n2["len"] == 21


def test_cancel_pending_drops_the_backlog_and_the_classes_requeue(fake_kernel, monkeypatch):
    """A bounded run stops without tuning its whole backlog: queued jobs are
    dropped (the running one finishes), and a dropped class queues again
    on its next submit."""
    gate = threading.Event()
    real_tune = AutotunedOp.tune_state

    def held(self, *args, **kwargs):
        gate.wait(30)  # the worker sits on its first job: the rest queue up
        return real_tune(self, *args, **kwargs)

    monkeypatch.setattr(AutotunedOp, "tune_state", held)
    tuner = BackgroundTuner()
    try:
        srv = _serve(background=tuner)
        dropped = tuner.cancel_pending()
        gate.set()
        assert dropped and tuner.drain(timeout=60) and tuner.pending == 0
        monkeypatch.setattr(AutotunedOp, "tune_state", real_tune)
        again = _serve(background=tuner, db=srv.db)  # the dropped classes requeue
        assert tuner.drain(timeout=120)
    finally:
        gate.set()
        tuner.stop()
    assert again.hot_path_cost_evaluations == 0
    assert set(dropped) <= set(tuner.tuned_labels)
    for op in (again.prefill_op, again.decode_op):
        assert all(st.tuned or st.from_cache for st in op.states().values())


def test_static_server_pads_without_a_mask_as_the_jax_server_does():
    """A JAX fault the port keeps: the static Server left-pads a group's
    prompts with token 0 and no mask, so a request's tokens depend on its
    batch-mates' prompt lengths.  Both packages part from their own
    unpadded one-at-a-time runs on the same requests; padding each prompt
    to its group's length first gives the batched tokens back."""
    import numpy as np

    from repro_torch.data import ServingRequest

    arch = "tinyllama-1.1b"
    cfg, jcfg = get_config(arch, smoke=True), jax_config(arch, smoke=True)
    jp, params = f32_weights(arch)
    reqs = mixed_traffic_trace(cfg, 4, seed=1, scale=0.25)
    batched = Server(cfg, params, batch_size=2, max_len=MAX_LEN).run(reqs)
    jax_batched = JaxServer(jcfg, jp, batch_size=2, max_len=MAX_LEN).run(
        jax_trace(jcfg, 4, seed=1, scale=0.25))
    assert batched == jax_batched
    one = Server(cfg, params, batch_size=1, max_len=MAX_LEN)
    jax_one = JaxServer(jcfg, jp, batch_size=1, max_len=MAX_LEN)
    alone, jax_alone, padded = {}, {}, {}
    for i, r in enumerate(reqs):
        alone.update(one.run([r]))
        jax_alone.update(jax_one.run([r]))
        plen = max(len(g.prompt) for g in reqs[i - i % 2: i - i % 2 + 2])
        prompt = np.concatenate([np.zeros(plen - len(r.prompt), np.int32), r.prompt])
        padded.update(one.run([ServingRequest(r.rid, prompt, r.max_new_tokens)]))
    parted = sorted(rid for rid in batched if batched[rid] != alone[rid])
    assert parted == sorted(rid for rid in jax_batched if jax_batched[rid] != jax_alone[rid])
    assert parted  # the padding reaches the tokens
    assert padded == batched


def test_cancel_pending_drops_only_the_labels_it_is_asked_to(fake_kernel, monkeypatch):
    """``cancel_pending(which)`` drops the queued jobs whose label ``which``
    accepts and leaves the others queued: they tune when the worker is
    free, and the dropped classes serve their default."""
    gate = threading.Event()
    real_tune = AutotunedOp.tune_state

    def held(self, *args, **kwargs):
        gate.wait(30)
        return real_tune(self, *args, **kwargs)

    monkeypatch.setattr(AutotunedOp, "tune_state", held)
    tuner = BackgroundTuner()
    try:
        srv = _serve(background=tuner)
        dropped = tuner.cancel_pending(lambda label: label.startswith("decode/"))
        gate.set()
        assert tuner.drain(timeout=60) and tuner.pending == 0
    finally:
        gate.set()
        tuner.stop()
    assert dropped and all(label.startswith("decode/") for label in dropped)
    tuned = set(tuner.tuned_labels)
    assert FAKE in tuned and any(label.startswith("prefill/") for label in tuned)
    assert not set(dropped) & tuned  # the worker held a prefill class when they were dropped
    decode = list(srv.decode_op.states().values())
    assert decode and any(not st.tuned for st in decode)


def test_launch_counts_keep_each_thread_apart():
    """The wrappers' counts add under a lock, per thread: a serving thread's
    share reads apart from another thread's calls of the same wrapper (a
    background tuner's trials), and the totals are their sum."""
    from repro_torch.kernels.flash_attention import flash_attention as fa_mod

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 8, 2, 16, generator=g) for _ in range(3))
    counter = fa_mod.counter
    counter.reset()
    other = []

    def trials():
        for _ in range(50):
            fa_mod.flash_attention(q, k, v, causal=True)
        other.append(threading.get_ident())

    t = threading.Thread(target=trials)
    t.start()
    for _ in range(30):
        fa_mod.flash_attention(q, k, v, causal=True)
    t.join()
    assert counter.on_thread(threading.get_ident()) == (0, 30)  # CPU: the plain version
    assert counter.on_thread(other[0]) == (0, 50)
    assert (counter.launches, counter.plain_calls) == (0, 80)
    counter.reset()
    assert counter.on_thread(threading.get_ident()) == (0, 0)


def test_a_recalled_kernel_class_runs_only_its_winner_on_the_serving_thread(fake_kernel):
    """On a DB hit the serving rule selects the winner and runs nothing
    else: no runner-up is warmed (launched) on the request path."""
    ran = []
    real = attention.full_attention

    def counted(q, k, v, causal=True):
        ran.append(threading.get_ident())
        return real(q, k, v, causal=causal)

    db = TuningDB()
    tuner = BackgroundTuner()
    try:
        _serve(background=tuner, db=db)
        assert tuner.drain(timeout=120)
    finally:
        tuner.stop()
    before = len(fake_kernel)
    with mock.patch.object(attention, "full_attention", counted):
        srv = _serve(db=db)
    kernels = _kernel_states(srv)
    assert kernels and all(st.from_cache and st.warmed == 0 for st in kernels)
    assert len(ran) == len(fake_kernel) - before  # one run a model call
