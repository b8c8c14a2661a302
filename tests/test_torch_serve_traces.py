"""The port's serving traffic, observability formats and serve CLI.

* traces: for each generator the port and the JAX package give the same
  requests from the same seed (prompts byte for byte, lengths, arrivals,
  deadlines, priorities);
* formats: ``MetricsRegistry.prometheus_text`` round-trips through
  ``parse_prometheus``, an engine's stats included; ``explain`` renders a
  port DB, and renders it as the JAX package's ``explain`` does;
* the CLI: ``python -m repro_torch.launch.serve`` on a SMOKE config on the
  CPU, static and streaming under chaos, and it refuses to run on a card
  it does not have.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.configs import get_config as jax_config
from repro import data as jax_data
from repro.core import TuningDB as JaxTuningDB
from repro.obs import explain as jax_explain
from repro_torch import data as port_data
from repro_torch.configs import get_config
from repro_torch.core import TuningDB
from repro_torch.data import synthetic_requests
from repro_torch.obs import MetricsRegistry, parse_prometheus
from repro_torch.obs import explain
from repro_torch.runtime import Server, StreamingEngine
from test_torch_serve_common import (  # noqa: F401 (the fixture is autouse)
    f32_weights, same_requests, restore_port_registry,
)

ROOT = Path(__file__).resolve().parent.parent

TRACES = {
    "synthetic": lambda m, cfg, seed: m.synthetic_requests(cfg, 5, 7, 3, seed=seed),
    "mixed": lambda m, cfg, seed: m.mixed_traffic_trace(cfg, 12, seed=seed),
    "mixed_scaled": lambda m, cfg, seed: m.mixed_traffic_trace(cfg, 9, seed=seed, scale=0.25),
    "bursty": lambda m, cfg, seed: m.bursty_open_loop_trace(cfg, 12, seed=seed, burst_size=3),
    "adversarial": lambda m, cfg, seed: m.adversarial_trace(
        cfg, 16, seed=seed, scale=0.5, malformed_rate=0.3, max_len_hint=24),
}


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-vl-2b"])
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("trace", sorted(TRACES))
def test_traces_match_the_jax_package(trace, seed, arch):
    port = TRACES[trace](port_data, get_config(arch, smoke=True), seed)
    ref = TRACES[trace](jax_data, jax_config(arch, smoke=True), seed)
    assert same_requests(port, ref)
    assert len(port) > 0


def test_prometheus_text_round_trips():
    reg = MetricsRegistry()
    reg.counter("req_total", help="requests").inc(3, status="ok")
    reg.counter("req_total").inc(1, status="error")
    reg.gauge("queue_depth").set(7)
    h = reg.histogram("lat_s", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    text = reg.prometheus_text()
    fams = parse_prometheus(text)
    assert fams["req_total"] == [({"status": "error"}, 1.0), ({"status": "ok"}, 3.0)]
    assert fams["queue_depth"] == [({}, 7.0)]
    assert fams["lat_s_count"] == [({}, 3.0)]
    assert fams["lat_s_sum"] == [({}, pytest.approx(5.55))]
    assert {lab["le"]: v for lab, v in fams["lat_s_bucket"]} == {
        "0.1": 1.0, "1": 2.0, "+Inf": 3.0}
    assert reg.prometheus_text() == text


def test_engine_stats_round_trip_through_prometheus():
    cfg = get_config("tinyllama-1.1b", smoke=True)
    _, params = f32_weights("tinyllama-1.1b")
    eng = StreamingEngine(cfg, params, n_blocks=2, max_len=16)
    eng.serve(synthetic_requests(cfg, 3, prompt_len=4, max_new_tokens=3))
    reg = MetricsRegistry()
    reg.register_stats("engine", eng.stats, help="streaming-engine stats")
    fams = parse_prometheus(reg.prometheus_text())
    assert fams["engine_tokens_out"] == [({}, 9.0)]
    assert fams["engine_requests_finished"] == [({}, 3.0)]
    for key, value in eng.stats.as_metrics().items():
        assert fams[f"engine_{key}"][0][1] == pytest.approx(float(value))


def test_explain_renders_a_port_db(tmp_path):
    """A port Server tuning inline fills its DB; ``explain`` reconstructs
    each class's decision, and the JAX ``explain`` reads the same file to
    the same report."""
    cfg = get_config("tinyllama-1.1b", smoke=True)
    _, params = f32_weights("tinyllama-1.1b")
    path = tmp_path / "serve_db.json"
    db = TuningDB(str(path))
    srv = Server(cfg, params, batch_size=2, max_len=16, tuning_db=db, inline_tune=True)
    srv.run(synthetic_requests(cfg, 2, prompt_len=4, max_new_tokens=3))
    db.save()
    reports = explain.explain_all(db)
    assert {r["kernel"] for r in reports} == {"serve_prefill", "serve_decode"}
    for report in reports:
        assert report["final"]["final"] and report["search"]["evaluations"] >= 2
        text = explain.render_report(report)
        assert "<- winner" in text and "decision:" in text
    summary = explain.db_summary(db)
    assert summary["entries"] == 2 and summary["finals"] == 2
    theirs = jax_explain.explain_all(JaxTuningDB(str(path)))
    assert [explain.render_report(r) for r in reports] == [
        jax_explain.render_report(r) for r in theirs]


def _cli(*args: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


def test_cli_serves_on_the_cpu_when_asked(tmp_path):
    metrics = tmp_path / "server.prom"
    out = _cli("--arch", "tinyllama-1.1b", "--device", "cpu", "--trace", "mixed",
               "--background-tune", "--metrics-out", str(metrics))
    assert out.returncode == 0, out.stderr
    assert "served 4 requests" in out.stdout
    assert "hot-path tuning evaluations: 0" in out.stdout
    assert "background-tuned classes: " in out.stdout
    assert parse_prometheus(metrics.read_text())["server_tokens_out"][0][1] > 0


def test_cli_stream_under_chaos_drains(tmp_path):
    trace = tmp_path / "trace.json"
    out = _cli("--arch", "tinyllama-1.1b", "--device", "cpu", "--stream",
               "--chaos-seed", "1", "--requests", "8", "--tick-timer", "0.001",
               "--trace-out", str(trace))
    assert out.returncode == 0, out.stderr
    assert "engine_retired{status=ok}" in out.stdout
    assert "hot-path tuning evaluations: 0" in out.stdout
    assert trace.stat().st_size > 0


def test_cli_needs_a_card_unless_asked_for_the_cpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    out = _cli("--arch", "tinyllama-1.1b")
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert "served" not in out.stdout
