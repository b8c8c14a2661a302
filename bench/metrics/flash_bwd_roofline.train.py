"""``flash_bwd_roofline.train``: the causal attention backward's share of
its roofline in the training step.

The least time of the backward calls the configuration and the shapes
imply (one a layer a step, the frozen ``flash_bwd_bound_s`` at the cell's
batch, sequence and heads in bf16) over the device time of the kernels
that do that work (``flash_bwd*``) in the traced window."""
from harness.yardstick import Sizes, flash_bwd_bound_s, share


def read(run):
    t, c = run.trace, run.counters
    if t is None or not c.get("steps"):
        return None
    s = Sizes.of(run.config["model"])
    if s.family not in ("dense", "moe", "vlm"):
        return None
    bound = flash_bwd_bound_s(c["batch"], c["seq"], s.n_heads, s.n_kv_heads, s.head_dim_)
    return share(bound * s.n_layers * c["steps"], t.seconds_of("flash_backward"))
