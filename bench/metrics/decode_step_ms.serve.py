"""``decode_step_ms.serve``: the engine's mean decode step
(``StreamStats.decode_s`` over ``decode_steps``) in the window, in ms."""


def read(run):
    c = run.counters
    if not c.get("decode_steps"):
        return None
    return 1e3 * c["decode_s"] / c["decode_steps"]
