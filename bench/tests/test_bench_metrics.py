"""The metric arithmetic: the yardstick's frozen copies against the program's
formulas today, the idle share and breakdown from synthetic profiler
intervals, and each per-layer reader on a hand-made run."""
import math

import pytest

from harness import manifest
from harness.outcome import Outcome, leaf_gaps, moving_leaves
from harness.trace import Interval, Trace, kind_of, union_seconds
from harness.yardstick import (
    HBM_BYTES_PER_S, PEAK_BF16_FLOPS, PEAK_FP32_FLOPS, Sizes, flash_bwd_bound_s, param_count,
    ssm_scan_bound_s, step_flops,
)

from conftest import SERVE, TRAIN


def sizes(cell):
    return Sizes.of(manifest.find_cell(cell).config["model"])


@pytest.mark.parametrize("cell", [TRAIN, SERVE])
@pytest.mark.parametrize("kind,batch,seq", [("train", 4, 4096), ("prefill", 1, 8192),
                                             ("decode", 16, 8200)])
def test_frozen_flops_match_the_programs_formula(cell, kind, batch, seq):
    from repro_torch.models import analytic_param_count, analytic_step_flops

    from harness.train import model_config

    c = manifest.find_cell(cell)
    cfg = model_config(c.config, c.job)
    s = sizes(cell)
    assert param_count(s) == analytic_param_count(cfg)
    assert param_count(s, True) == analytic_param_count(cfg, active_only=True)
    assert step_flops(s, kind, batch, seq) == analytic_step_flops(cfg, kind, batch, seq)


def test_granite_train_step_flops_by_hand():
    s = sizes(TRAIN)
    d, H, KV, hd, ff, E, k, V, L = 1024, 16, 8, 64, 512, 32, 8, 49155, 24
    attn = d * H * hd + 2 * d * KV * hd + H * hd * d
    active = V * d + L * (attn + d * E + 3 * k * d * ff + 2 * d) + d
    tokens = 4 * 4096
    want = 6 * active * tokens + L * 4 * 4096 * 4096 * H * hd * 4 * 0.5 * 3
    assert step_flops(s, "train", 4, 4096) == pytest.approx(want, rel=1e-12)


def test_ssm_scan_bound_matches_the_kernels_traffic():
    from repro_torch.kernels.ssm_scan.ssm_scan import traffic

    flops, bytes_ = traffic(2, 4096, 8192, 16, 4)
    ours = ssm_scan_bound_s(2, 4096, 8192, 16, 4, final_state=False)
    # the kernel's count adds A and D (read once a call); the yardstick leaves them out
    assert ours == pytest.approx(max(flops / PEAK_FP32_FLOPS,
                                     (bytes_ - 4.0 * (8192 * 16 + 8192)) / HBM_BYTES_PER_S))
    with_state = ssm_scan_bound_s(2, 4096, 8192, 16, 4)
    assert with_state - ours == pytest.approx(4.0 * 2 * 8192 * 16 / HBM_BYTES_PER_S)


def test_flash_bwd_bound_by_hand():
    B, S, H, KV, hd = 4, 4096, 16, 8, 64
    ops = 5 * 2.0 * B * H * S * S * hd / 2 / PEAK_BF16_FLOPS
    by_bytes = (2 * B * S * hd * (4 * H + 4 * KV) + 4 * B * H * S) / HBM_BYTES_PER_S
    assert flash_bwd_bound_s(B, S, H, KV, hd) == max(ops, by_bytes) == ops


def test_union_and_kinds():
    assert union_seconds([(0, 10), (5, 20), (30, 40)]) == pytest.approx(30e-9)
    assert union_seconds([(0, 10), (2, 3)]) == pytest.approx(10e-9)
    assert kind_of("void flash_bwd_dq_sm90<64, 128, 64>(...)") == "flash_backward"
    assert kind_of("void ssm_kernel<float, 4, true>(SsmArgs)") == "ssm_scan_forward"
    assert kind_of("void ssm_bwd_kernel<8,1,4>(...)") == "ssm_scan_backward"
    assert kind_of("sm90_xmma_gemm_bf16bf16_bf16f32") == "gemm"
    assert kind_of("nvjet_tst_128x256_64x4_2x1_v_bz_coopA_TNT") == "gemm"
    assert kind_of("void at::native::vectorized_elementwise_kernel<4>") == "eager"


def synthetic_trace():
    # window 0..100 ns; ops at 10-30 and 20-40 (overlapping), 60-70; host in
    # bench.step 0-50, bench.loss_read 50-80, nothing labelled after
    ops = [Interval("gemm_a", 10, 30), Interval("elementwise", 20, 40),
           Interval("flash_bwd_dkv", 60, 70)]
    spans = [Interval("bench.step", 0, 50), Interval("bench.loss_read", 50, 80)]
    return Trace(Interval("bench.window", 0, 100), ops, spans)


def test_idle_share_and_breakdown_from_synthetic_events():
    t = synthetic_trace()
    assert t.window_s == pytest.approx(100e-9)
    assert t.busy_s == pytest.approx(40e-9)
    gaps = t.idle_gaps()
    # gaps: 70-100 (loss_read 10 of 30, outside every span 20), 40-60 (step 10,
    # loss_read 10: the innermost, shorter span), 0-10 (step)
    assert [g[1] for g in gaps] == pytest.approx([30e-9, 20e-9, 10e-9])
    assert [g[0] for g in gaps] == ["bench.window", "bench.loss_read", "bench.step"]
    reader = manifest.metric_reader("device_idle_share.train")
    run = Outcome(0, 1e-7, {}, 1, 0, {}, 0, trace=t)
    assert reader(run) == pytest.approx(60.0)
    top = t.top_ops()
    assert [name for name, _ in top] == ["gemm_a", "elementwise", "flash_bwd_dkv"]
    assert manifest.metric_reader("eager_share.train")(run) == pytest.approx(100 * 20 / 50)


def train_run(trace=None, steps=10, window=8.0):
    c = manifest.find_cell(TRAIN)
    return Outcome(1.0, window, {}, steps, 0, {}, 0,
                   counters={"steps": steps, "batch": 4, "seq": 4096, "hot_path_evaluations": 0},
                   trace=trace, config=c.config, job=c.job)


def test_train_readers_by_hand():
    s = sizes(TRAIN)
    run = train_run()
    want = 100 * step_flops(s, "train", 4, 4096) * 10 / (8.0 * PEAK_BF16_FLOPS)
    assert manifest.metric_reader("train_mfu")(run) == pytest.approx(want)
    assert manifest.metric_reader("hot_path_evaluations.train")(run) == 0.0
    # 240 backward calls' bound over 0.5 s of flash_bwd kernels
    ops = [Interval("flash_bwd_dq_sm90", 0, 250_000_000),
           Interval("flash_bwd_dkv_sm90", 250_000_000, 500_000_000)]
    run = train_run(Trace(Interval("bench.window", 0, 8 * 10**9), ops))
    bound = flash_bwd_bound_s(4, 4096, 16, 8, 64) * 24 * 10
    assert manifest.metric_reader("flash_bwd_roofline.train")(run) == pytest.approx(
        100 * bound / 0.5)
    # nothing to read: no flash backward kernels in the trace
    run = train_run(Trace(Interval("bench.window", 0, 10), [Interval("gemm", 0, 5)]))
    assert manifest.metric_reader("flash_bwd_roofline.train")(run) is None


def test_serve_readers_by_hand():
    c = manifest.find_cell(SERVE)
    s = sizes(SERVE)
    reqs = [(1024, 4), (8192, 16)]
    ops = [Interval("void ssm_kernel<float, 4, true>(SsmArgs)", 0, 10**9)]
    run = Outcome(1.0, 20.0, {}, 2, 0, {}, 0, counters={
        "requests": reqs, "prompt_tokens": 9216, "prefill_s": 3.0, "decode_s": 2.0,
        "decode_steps": 16, "serve_s": 20.0, "hot_path_evaluations": 0},
        trace=Trace(Interval("bench.window", 0, 20 * 10**9), ops), config=c.config, job=c.job)
    flops = sum(step_flops(s, "prefill", 1, p) + sum(step_flops(s, "decode", 1, p + j)
                                                   for j in range(1, n)) for p, n in reqs)
    read = manifest.metric_reader
    assert read("serve_mfu")(run) == pytest.approx(100 * flops / (20.0 * PEAK_BF16_FLOPS))
    assert read("engine_host_share.serve")(run) == pytest.approx(75.0)
    assert read("prefill_ms_per_ktok.serve")(run) == pytest.approx(1e6 * 3.0 / 9216)
    assert read("decode_step_ms.serve")(run) == pytest.approx(125.0)
    bound = 64 * sum(ssm_scan_bound_s(1, p, 8192, 16) for p, _ in reqs)
    assert read("ssm_scan_roofline.serve")(run) == pytest.approx(100 * bound / 1.0)
    assert read("device_idle_share.serve")(run) == pytest.approx(95.0)


def test_leaf_gaps_use_the_larger_of_the_leaf_and_the_median():
    ref = {"a": 1.0, "b": 2.0, "c": 3.0, "tiny": 1e-6}
    prog = {"a": 1.1, "b": 2.0, "c": 3.0, "tiny": 2e-6}
    gaps = leaf_gaps(prog, ref)
    assert gaps["a"] == pytest.approx(0.1 / 1.5)
    assert gaps["tiny"] == pytest.approx(1e-6 / 1.5)
    assert max(gaps, key=gaps.get) == "a"
    assert moving_leaves(ref) == ["a", "b", "c"]
    assert math.isinf(leaf_gaps({**prog, "a": float("nan")}, ref)["a"])
