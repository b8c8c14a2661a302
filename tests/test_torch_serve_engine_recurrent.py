"""The port's ``StreamingEngine`` against the JAX package's at the two
recurrent families' published widths: the cut FULL configs of
``test_torch_models_fullwidth_recurrent`` (falcon-mamba-7b at 2 layers,
recurrentgemma-2b at 3, a 512-token vocabulary), float32 weights (the JAX
init, wq and wk tempered, carried across by ``carry.model_params``), on
``bursty_open_loop_trace(cfg, 8, seed=0, burst_size=4, burst_gap_s=0.05,
scale=0.25)`` with a ``TickTimer`` on both sides and no tuning, as
``test_torch_serve_engine`` holds the SMOKE configs: status and tokens
equal rid for rid, and the step counts.  The JAX engine runs jitted."""
from __future__ import annotations

import functools

import jax
import pytest

import test_torch_models_parity as P
from repro.data import bursty_open_loop_trace as jax_trace
from repro.obs import TickTimer as JaxTickTimer
from repro.runtime import StreamingEngine as JaxEngine
from repro_torch import carry
from repro_torch.data import bursty_open_loop_trace
from repro_torch.obs import TickTimer
from repro_torch.runtime import StreamingEngine
from test_torch_models_fullwidth_recurrent import CUTS
from test_torch_serve_common import restore_port_registry  # noqa: F401 (autouse)

TRACE = dict(seed=0, burst_size=4, burst_gap_s=0.05, scale=0.25)
N_REQUESTS = 8
N_BLOCKS = 4


@functools.lru_cache(maxsize=None)
def weights(arch: str):
    """(JAX float32 params, the port's on the CPU) of the cut FULL config."""
    jp = P.jax_params(arch, "f32-tempered", cut=CUTS[arch])
    cfg = P.configs(arch, CUTS[arch])[1]
    return jp, carry.model_params(cfg, jax.device_get(jp), device="cpu")


@pytest.mark.parametrize("arch", list(CUTS))
def test_engine_matches_the_jax_engine_at_full_width(arch):
    jcfg, cfg = P.configs(arch, CUTS[arch])
    jp, params = weights(arch)
    trace = bursty_open_loop_trace(cfg, N_REQUESTS, **TRACE)
    max_len = max(len(r.prompt) + r.max_new_tokens for r in trace)
    assert max_len < cfg.local_window
    ours = StreamingEngine(cfg, params, n_blocks=N_BLOCKS, max_len=max_len, timer=TickTimer())
    out = ours.serve(trace)
    theirs = JaxEngine(jcfg, jp, n_blocks=N_BLOCKS, max_len=max_len, timer=JaxTickTimer())
    ref = theirs.serve(jax_trace(jcfg, N_REQUESTS, **TRACE))
    assert out == ref and len(out) == N_REQUESTS
    assert {rid: (r.status, r.tokens) for rid, r in ours.results.items()} == {
        rid: (r.status, r.tokens) for rid, r in theirs.results.items()}
    for key in ("prefill_steps", "decode_steps", "prefill_calls", "decode_calls",
                "tokens_out", "peak_in_flight"):
        assert getattr(ours.stats, key) == getattr(theirs.stats, key), key
    assert ours.stats.peak_in_flight > 1  # rows at mixed positions shared steps
    assert ours.cache.free == ours.cache.n_blocks and ours.hot_path_cost_evaluations == 0
