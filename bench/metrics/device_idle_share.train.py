"""``device_idle_share.train``: the share of the traced window in which no
operation ran on the card (1 - the union of device-operation intervals
over the window), in the training cell."""


def read(run):
    t = run.trace
    if t is None or not t.ops or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
