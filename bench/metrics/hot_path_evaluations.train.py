"""``hot_path_evaluations.train``: tuning cost evaluations that the
Trainer's serving rule and its TuningDB spent inside the window (0 when
set-up tuned or recalled every kernel shape class the step reaches)."""


def read(run):
    value = run.counters.get("hot_path_evaluations")
    return None if value is None else float(value)
