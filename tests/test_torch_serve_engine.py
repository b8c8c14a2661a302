"""The port's ``StreamingEngine`` against the JAX package's, against its own
one-request-at-a-time oracle, and the per-row decode it stands on.

* engine parity: on the float32 SMOKE config of one arch per family, both
  engines serve ``bursty_open_loop_trace`` with a ``TickTimer`` (the
  virtual clock is the same on both sides) and no tuning; status and
  tokens are equal rid for rid, and so are the step counts;
* the oracle: the port's ``Server(batch_size=1)``, request by request; the
  greedy tokens are equal.  Each batched decode step is also held against
  the batch-1 decode of each of its rows on the same cache: on the CPU a
  batch-of-rows GEMM may round differently from a batch-1 one in the last
  float32 bit, and where that value is then stored in the bf16 KV cache the
  bit can flip one bf16 ulp (2⁻⁸ relative), so the worst logits row is held
  to ``ROW_REL`` = 2⁻⁸ (its largest error over its largest |logit|) rather
  than to bit equality, and printed;
* per-row ``len``: a batched decode of rows at mixed positions equals the
  batch-1 decode of each row (dense; hybrid with a row past its window;
  vlm; encdec), logits and caches, over a few steps.
"""
from __future__ import annotations

import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data import bursty_open_loop_trace as jax_trace
from repro.obs import TickTimer as JaxTickTimer
from repro.runtime import StreamingEngine as JaxEngine
from repro_torch import models as tm
from repro_torch.configs import get_config
from repro_torch.data import ServingRequest, bursty_open_loop_trace, synthetic_requests
from repro_torch.obs import TickTimer
from repro_torch.runtime import Server, StreamingEngine
from repro_torch.runtime import engine as engine_mod
from repro_torch.runtime.serve import _cache_concat, build_batch_inputs, decode_inputs
from test_torch_serve_common import (  # noqa: F401 (the fixture is autouse)
    FAMILIES, f32_weights, jax_run_mode, restore_port_registry,
)

ROW_REL = 2.0 ** -8
N_REQUESTS = {"whisper-large-v3": 4}  # op by op on the JAX side: fewer


def _trace(module, cfg, arch):
    return module(cfg, N_REQUESTS.get(arch, 8), seed=3, scale=0.25, burst_size=3)


def _max_len(trace):
    return max(len(r.prompt) + r.max_new_tokens for r in trace)


@pytest.mark.parametrize("arch", FAMILIES)
def test_engine_matches_the_jax_engine(arch):
    cfg = get_config(arch, smoke=True)
    jp, params = f32_weights(arch)
    trace = _trace(bursty_open_loop_trace, cfg, arch)
    ours = StreamingEngine(cfg, params, n_blocks=4, max_len=_max_len(trace),
                           timer=TickTimer())
    out = ours.serve(trace)
    jcfg = jax_config(arch, smoke=True)
    theirs = JaxEngine(jcfg, jp, n_blocks=4, max_len=_max_len(trace), timer=JaxTickTimer())
    with jax_run_mode(arch):
        ref = theirs.serve(_trace(jax_trace, jcfg, arch))
    assert out == ref
    assert {rid: (r.status, r.tokens) for rid, r in ours.results.items()} == {
        rid: (r.status, r.tokens) for rid, r in theirs.results.items()}
    for key in ("prefill_steps", "decode_steps", "prefill_calls", "decode_calls",
                "tokens_out", "peak_in_flight"):
        assert getattr(ours.stats, key) == getattr(theirs.stats, key), key
    assert ours.stats.ttft_s == pytest.approx(theirs.stats.ttft_s)
    assert ours.cache.free == ours.cache.n_blocks and ours.hot_path_cost_evaluations == 0


def _oracle(cfg, params, reqs, max_len):
    srv = Server(cfg, params, batch_size=1, max_len=max_len)
    out = {}
    for r in reqs:
        out.update(srv.run([ServingRequest(rid=r.rid, prompt=r.prompt,
                                           max_new_tokens=r.max_new_tokens)]))
    return out


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "recurrentgemma-2b", "qwen2-vl-2b",
                                  "granite-moe-1b-a400m"])
def test_engine_matches_its_oracle(arch, monkeypatch):
    cfg = get_config(arch, smoke=True)
    _, params = f32_weights(arch)
    trace = bursty_open_loop_trace(cfg, 8, seed=5, scale=0.25, burst_size=4)
    max_len = _max_len(trace)
    worst = []
    real = engine_mod.decode_fn

    def checked(p, batch, rows, step_cfg):
        """The batched step, and each row's batch-1 step on a copy of it."""
        singles = []
        for i in range(batch["tokens"].shape[0]):
            row = {k: v if k == "len" else v.narrow(tm.cache_batch_axis(k, v.ndim), i, 1)
                   for k, v in rows.items()}
            row = {k: int(v[i]) if k == "len" else v.clone() for k, v in row.items()}
            one = decode_inputs(cfg, batch["tokens"][i:i + 1, 0], row["len"])
            singles.append(real(p, one, row, cfg)[0])
        logits, new_rows = real(p, batch, rows, step_cfg)
        ref = torch.cat(singles)
        err = (logits - ref).abs().amax(-1) / ref.abs().amax(-1)
        worst.append(float(err.max()))
        return logits, new_rows

    monkeypatch.setattr(engine_mod, "decode_fn", checked)
    eng = StreamingEngine(cfg, params, n_blocks=4, max_len=max_len)
    out = eng.serve(trace)
    assert eng.stats.peak_in_flight > 1  # rows at mixed positions shared steps
    assert out == _oracle(cfg, params, trace, max_len)
    print(f"{arch}: worst logits row of {len(worst)} batched decode steps against "
          f"batch-1: {max(worst):.3e} (tol {ROW_REL})")
    assert max(worst) <= ROW_REL


PER_ROW = {
    "tinyllama-1.1b": (3, 9, 14),
    "recurrentgemma-2b": (5, 11, 20),  # local_window 16: the last row wraps its ring
    "qwen2-vl-2b": (9, 12, 17),        # past the 8 vision tokens
    "whisper-large-v3": (2, 6, 9),
}


@pytest.mark.parametrize("arch", sorted(PER_ROW))
def test_batched_decode_at_mixed_positions_equals_batch1(arch):
    cfg = get_config(arch, smoke=True)
    _, params = f32_weights(arch)
    cap, steps = 32, 3
    reqs = [ServingRequest(rid=i, prompt=r.prompt, max_new_tokens=steps)
            for i, (r, n) in enumerate(zip(synthetic_requests(cfg, 3, 24, steps, seed=2),
                                           PER_ROW[arch]))]
    for r, n in zip(reqs, PER_ROW[arch]):
        r.prompt = r.prompt[:n]
    rows, toks = [], []
    for r in reqs:
        logits, cache = tm.prefill_fn(params, build_batch_inputs(cfg, [r], len(r.prompt),
                                                                 "cpu"), cfg, capacity=cap)
        rows.append(cache)
        toks.append(logits.argmax(-1).to(torch.int32))
    batched = _cache_concat([{**c, "len": torch.tensor([c["len"]])} for c in rows])
    assert batched["len"].tolist() == list(PER_ROW[arch])
    tok = torch.cat(toks)
    for step in range(steps):
        logits, batched = tm.decode_fn(params, decode_inputs(cfg, tok, batched["len"]),
                                       batched, cfg)
        singles = []
        for i, c in enumerate(rows):
            one, rows[i] = tm.decode_fn(params, decode_inputs(cfg, tok[i:i + 1], c["len"]),
                                        c, cfg)
            singles.append(one)
        ref = torch.cat(singles)
        err = (logits - ref).abs().amax(-1) / ref.abs().amax(-1)
        assert float(err.max()) <= ROW_REL, (arch, step, err)
        assert torch.equal(logits.argmax(-1), ref.argmax(-1))
        tok = ref.argmax(-1).to(torch.int32)
    assert batched["len"].tolist() == [n + steps for n in PER_ROW[arch]]
    for k, v in batched.items():
        if k == "len":
            continue
        ax = tm.cache_batch_axis(k, v.ndim)
        ref = torch.cat([c[k] for c in rows], dim=ax)
        # bf16 leaves (K/V, conv windows) may round one ulp apart
        tol = 1e-5 if v.dtype == torch.float32 else 2.0 ** -7
        torch.testing.assert_close(v.float(), ref.float(), rtol=tol, atol=tol, msg=k)


def test_pool_gather_scatter_round_trip():
    """Insert writes each prefilled row into its block with its length;
    gather copies; scatter writes back only the rows asked for."""
    cfg = get_config("recurrentgemma-2b", smoke=True)
    _, params = f32_weights("recurrentgemma-2b")
    pool = engine_mod.PagedKVCache(cfg, n_blocks=4, capacity=24, device="cpu")
    reqs = synthetic_requests(cfg, 2, 20, 2)
    _, cache = tm.prefill_fn(params, build_batch_inputs(cfg, reqs, 20, "cpu"), cfg,
                             capacity=24)
    for r in reqs:
        pool.allocate(r.rid)
    pool.insert([r.rid for r in reqs], cache)
    blocks = torch.tensor([pool.block_of(r.rid) for r in reqs])
    assert pool.pool["len"][blocks].tolist() == [20, 20]
    rows = engine_mod._take_rows(pool.pool, blocks)
    for k, v in cache.items():
        if k != "len":
            assert torch.equal(rows[k], v.to(rows[k].dtype)), k
    snapshot = {k: v.clone() for k, v in pool.pool.items()}
    for v in rows.values():
        v.add_(1)  # a copy: the pool does not see it
    assert all(torch.equal(pool.pool[k], snapshot[k]) for k in snapshot)
    pool.scatter(blocks, rows, 1)
    assert pool.pool["len"][blocks].tolist() == [21, 20]
    other = [b for b in range(4) if b not in blocks.tolist()]
    for k, v in pool.pool.items():
        ax = 0 if k == "len" else tm.cache_batch_axis(k, v.ndim)
        untouched = torch.tensor(other + [int(blocks[1])])
        assert torch.equal(v.index_select(ax, untouched),
                           snapshot[k].index_select(ax, untouched)), k


def test_engine_stats_and_retirement():
    cfg = get_config("falcon-mamba-7b", smoke=True)
    _, params = f32_weights("falcon-mamba-7b")
    trace = bursty_open_loop_trace(cfg, 6, seed=1, scale=0.25, burst_size=3)
    eng = StreamingEngine(cfg, params, n_blocks=2, max_len=_max_len(trace))
    out = eng.serve(trace)
    s = eng.stats
    assert set(out) == {r.rid for r in trace}
    assert s.tokens_out == sum(r.max_new_tokens for r in trace)
    assert set(s.ttft_s) == set(s.finish_s) == {r.rid for r in trace}
    assert s.peak_in_flight <= 2 and eng.cache.allocator.peak_in_use <= 2
    assert s.tok_per_s > 0 and s.makespan_s > 0
    assert set(s.as_metrics()) >= {"tokens_out", "ttft_p50_s", "ttft_p99_s", "tok_per_s"}
