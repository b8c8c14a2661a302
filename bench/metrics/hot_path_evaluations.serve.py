"""``hot_path_evaluations.serve``: tuning cost evaluations paid on the
serving thread inside the window, ``StreamingEngine.hot_path_cost_evaluations``
(by the engine's ops and by the kernels the model calls)."""


def read(run):
    value = run.counters.get("hot_path_evaluations")
    return None if value is None else float(value)
