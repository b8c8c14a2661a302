"""``eager_share.train``: the device time of eager work (kernels that are
neither GEMMs nor the port's hand-written kernels: element-wise ops,
reductions, indexing, copies of the model, the MoE dispatch and AdamW) over
all device time in the traced window."""


def read(run):
    t = run.trace
    if t is None or not t.ops:
        return None
    total = t.device_seconds()
    return 100.0 * t.seconds_of("eager") / total if total > 0 else None
