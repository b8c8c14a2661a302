"""The drift watch's CUDA samples: a sample whose host enqueue outlasted the
spin before it (so the stream may have idled between its events) feeds
neither the watch nor the straggler selector.

CPU only: the CUDA events and the call's device are stand-ins, so the test
pins the rule, not the card's timing.
"""
from __future__ import annotations

import importlib
import math

import pytest
import torch

import repro_torch.core as tcore
from repro_torch.core import cost as cost_mod
from repro_torch.fleet import DriftMonitor

# the module, not the package's ``autotuned`` function of the same name
autotuned_mod = importlib.import_module("repro_torch.core.autotuned")


class _Event:
    """A CUDA event stand-in: ``elapsed_time`` 0.5 ms; the start event
    reports ``query()`` as the test sets it."""

    done = False

    def __init__(self, enable_timing=False):
        self.recorded = False

    def record(self):
        self.recorded = True

    def query(self):
        return _Event.done

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return 0.5


@pytest.mark.parametrize("start_done, expected", [(False, 0.5e-3), (True, None)])
def test_a_sample_is_dropped_when_the_spin_ran_out(monkeypatch, start_done, expected):
    spun = []
    monkeypatch.setattr(_Event, "done", start_done)
    monkeypatch.setattr(cost_mod.torch.cuda, "Event", _Event)
    monkeypatch.setattr(cost_mod, "spin", lambda device: lambda: spun.append(device))
    monkeypatch.setattr(cost_mod, "_is_cuda", lambda out: True)
    out, seconds = cost_mod.sampled_call(lambda: "out", "cuda:0")
    assert out == "out" and spun == ["cuda:0"]
    assert seconds == expected


def test_a_sample_of_a_host_result_reads_the_host_clock(monkeypatch):
    monkeypatch.setattr(cost_mod.torch.cuda, "Event", _Event)
    monkeypatch.setattr(cost_mod, "spin", lambda device: lambda: None)
    out, seconds = cost_mod.sampled_call(lambda: torch.ones(2), "cuda:0")
    assert torch.equal(out, torch.ones(2)) and 0.0 <= seconds < 1.0


def _toy_spec():
    def make_region(bp):
        def instantiate(pt):
            return lambda x: x + pt["i"]
        return tcore.ATRegion("sample_toy", tcore.ParamSpace(
            [tcore.PerfParam("i", (0, 1))]), instantiate)

    return tcore.KernelSpec(
        name="drift_sample_toy", make_region=make_region,
        shape_class=lambda x: tcore.BasicParams.make(kernel="drift_sample_toy",
                                                     n=int(x.shape[0])),
        cost_factory=lambda *a: (lambda point: 1e-3 * (1 + point["i"])))


class _Seen(DriftMonitor):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.fed = []

    def observe(self, op, state, cost, args=(), kwargs=None):
        self.fed.append(cost)
        return super().observe(op, state, cost, args, kwargs)


def test_host_bound_samples_feed_neither_the_watch_nor_the_selector(monkeypatch):
    # a run of samples, each a host-bound None or a clean device time; the
    # Nones are ten times the recorded cost were they read as times
    script = [None, 1e-3, None, None, 1e-3, 1e-3, None, 1e-3, 1e-3, None]
    pending = list(script)
    monitor = _Seen(factor=2.0, min_observations=1)
    op = tcore.AutotunedOp(_toy_spec(), db=tcore.TuningDB(), monitor_every=1,
                           tolerance=math.inf, drift=monitor)
    x = torch.ones(4)
    op(x)  # tuned on the host: the final is {'i': 0} at 1 ms
    (state,) = op.states().values()
    selected = []
    monkeypatch.setattr(state.selector, "observe", selected.append)
    monitor.fed.clear()
    checks = monitor.checks
    monkeypatch.setattr(autotuned_mod, "call_device", lambda a, k: torch.device("cuda", 0))
    monkeypatch.setattr(autotuned_mod, "sampled_call", lambda fn, device: (fn(), pending.pop(0)))
    for _ in script:
        assert torch.equal(op(x), x)
    clean = [c for c in script if c is not None]
    assert monitor.fed == selected == clean
    assert op.host_bound_samples == len(script) - len(clean)
    assert monitor.transitions == [] and monitor.checks - checks == len(clean)
