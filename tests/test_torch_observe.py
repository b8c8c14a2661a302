"""The port's observe CLI against the JAX package's, on the CPU.

``report`` and ``explain`` print the same text for one DB file from both
CLIs, and so do ``trace`` and ``metrics`` for one trace and one metrics
file the port wrote; ``trace`` and ``metrics`` exit non-zero on malformed
input, and ``metrics --url`` reads the port's tuning service over the
loopback.
"""
from __future__ import annotations

import json
import sys

import pytest
import torch

import repro.launch.observe as jobserve
import repro_torch.core as tcore
import repro_torch.launch.observe as tobserve
from repro_torch.fleet import DriftMonitor, TuningService, serve_http
from repro_torch.obs import MetricsRegistry, Tracer
from test_torch_fleet import _toy_spec
from test_torch_serve_common import restore_port_registry  # noqa: F401  (autouse)


def _cli(module, monkeypatch, capsys, *argv):
    monkeypatch.setattr(sys, "argv", ["observe", *argv])
    with pytest.raises(SystemExit) as done:
        module.main()
    return done.value.code, capsys.readouterr().out


@pytest.fixture
def db_path(tmp_path):
    """A port DB with a tuned class, a warm-started sibling and a drift
    lifecycle in its event log."""
    path = str(tmp_path / "db.json")
    db = tcore.TuningDB(path)
    costs = {0: 1.0, 1: 0.5, 2: 2.0}
    op = tcore.AutotunedOp(_toy_spec(tcore, costs), db=db, warm=False)
    state = op.resolve(torch.ones(4))
    op.resolve(torch.ones(8))  # warm-started from the n=4 class
    monitor = DriftMonitor(factor=2.0, min_observations=2, canary_window=2)
    costs.update({1: 2.0, 0: 0.3})
    for cost in (2.0, 2.0, 0.3, 0.3):
        monitor.observe(op, state, cost, (torch.ones(4),), {})
    return path


@pytest.mark.parametrize("argv", [
    ("report",), ("explain",), ("explain", "--json"), ("explain", "--kernel", "fleet_toy"),
    ("explain", "--kernel", "absent"), ("explain", "--fingerprint", "nope"),
])
def test_report_and_explain_print_what_jax_prints(db_path, argv, monkeypatch, capsys):
    args = (argv[0], "--db", db_path, *argv[1:])
    jax_rc, jax_out = _cli(jobserve, monkeypatch, capsys, *args)
    port_rc, port_out = _cli(tobserve, monkeypatch, capsys, *args)
    assert (port_rc, port_out) == (jax_rc, jax_out)
    assert port_rc == (1 if ("absent" in argv or "nope" in argv) else 0)
    if argv == ("explain",):
        assert "promoted" in port_out and "fleet_toy" in port_out


def _trace_file(tmp_path):
    tracer = Tracer()
    with tracer.span("tuner.tune", cat="tuner", op="exb"):
        tracer.instant("bgtuner.swap", cat="bgtuner", label="exb")
    path = tmp_path / "trace.json"
    tracer.write(str(path))
    return path


def test_trace_validates_what_jax_validates(tmp_path, monkeypatch, capsys):
    path = str(_trace_file(tmp_path))
    jax_rc, jax_out = _cli(jobserve, monkeypatch, capsys, "trace", "--path", path)
    port_rc, port_out = _cli(tobserve, monkeypatch, capsys, "trace", "--path", path)
    assert (port_rc, port_out) == (jax_rc, jax_out)
    assert port_rc == 0 and "trace OK: 2 events" in port_out


@pytest.mark.parametrize("doc", [
    "not json", json.dumps([1, 2]), json.dumps({"traceEvents": {}}),
    json.dumps({"traceEvents": [{"ph": "Q", "name": "x", "ts": 0, "pid": 1, "tid": 1}]}),
    json.dumps({"traceEvents": [{"ph": "X", "name": "x", "ts": 0, "pid": 1, "tid": 1}]}),
])
def test_trace_exits_non_zero_on_malformed_input(tmp_path, doc, monkeypatch, capsys):
    path = tmp_path / "bad.json"
    path.write_text(doc)
    rc, out = _cli(tobserve, monkeypatch, capsys, "trace", "--path", str(path))
    assert rc == 1 and out.startswith("ERROR")


def test_metrics_validates_what_jax_validates(tmp_path, monkeypatch, capsys):
    reg = MetricsRegistry()
    reg.counter("served_requests", help="requests").inc(3, status="ok")
    reg.gauge("queue_depth", help="waiting").set(2)
    reg.histogram("step_seconds", help="steps").observe(0.02)
    path = str(tmp_path / "metrics.prom")
    reg.write(path)
    jax_rc, jax_out = _cli(jobserve, monkeypatch, capsys, "metrics", "--path", path)
    port_rc, port_out = _cli(tobserve, monkeypatch, capsys, "metrics", "--path", path)
    assert (port_rc, port_out) == (jax_rc, jax_out)
    assert port_rc == 0 and "served_requests{status=ok} = 3.0" in port_out
    bad = tmp_path / "bad.prom"
    bad.write_text("queue_depth{oops 2\n")
    rc, out = _cli(tobserve, monkeypatch, capsys, "metrics", "--path", str(bad))
    assert rc == 1 and out.startswith("ERROR")
    rc, out = _cli(tobserve, monkeypatch, capsys, "metrics", "--path", str(tmp_path / "none"))
    assert rc == 1 and out.startswith("ERROR")


def test_metrics_reads_the_service_over_the_loopback(monkeypatch, capsys):
    service = TuningService()
    try:
        server = serve_http(service, host="127.0.0.1", port=0)
    except OSError as e:  # a sandbox without a loopback bind
        pytest.skip(f"cannot bind a loopback port: {e}")
    host, port = server.server_address[:2]
    try:
        rc, out = _cli(tobserve, monkeypatch, capsys, "metrics", "--url",
                       f"http://{host}:{port}/metrics")
    finally:
        server.shutdown()
        server.server_close()
    assert rc == 0 and "tuning_service_push = 0.0" in out
