"""The static Server feeds the drift watch no prefill class's first call in
its process: that call pays what a process pays once (kernel modules
loaded, the class's shapes met first), which is no drift of the final."""
from __future__ import annotations

from test_torch_drift import _Counting, _cpu_server
from test_torch_serve_common import restore_port_registry  # noqa: F401  (autouse)


class _ByOp(_Counting):
    """Counts what it is fed, by op."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.by_op = {}

    def observe(self, op, state, cost, args=(), kwargs=None):
        name = op.spec.name
        self.by_op[name] = self.by_op.get(name, 0) + 1
        return super().observe(op, state, cost, args, kwargs)


def test_a_prefill_class_s_first_call_feeds_no_drift_watch():
    from repro_torch.data import synthetic_requests

    monitor = _ByOp(factor=2.0)
    cfg, server = _cpu_server(inline_tune=True, drift_monitor=monitor)
    prefill, decode = server.prefill_op.spec.name, server.decode_op.spec.name
    server.run(synthetic_requests(cfg, 2, 4, 3))  # one group: its prefill is the class's first
    assert monitor.by_op == {decode: 1}
    server.run(synthetic_requests(cfg, 4, 4, 3, seed=1))  # two more groups of the class
    assert monitor.by_op == {decode: 3, prefill: 2}
    long = synthetic_requests(cfg, 2, 12, 3, seed=2)  # another prompt bucket: a new class
    server.run(long)
    assert monitor.by_op == {decode: 4, prefill: 2}
    assert monitor.transitions == []
