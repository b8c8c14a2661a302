"""``engine_host_share.serve``: the share of the ``serve()`` calls' wall
time the engine spent outside its timed prefill and decode steps
(``StreamStats.prefill_s`` + ``decode_s``, each a step timed around a
synchronize): scheduling, admission, batch building, token reads."""


def read(run):
    c = run.counters
    if not c.get("serve_s"):
        return None
    return 100.0 * (1.0 - (c["prefill_s"] + c["decode_s"]) / c["serve_s"])
