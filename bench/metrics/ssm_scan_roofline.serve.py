"""``ssm_scan_roofline.serve``: the selective-scan forward's share of its
roofline in the served prefills.

The least time of the scan calls the completed requests imply (each
prompt through every layer, with the final state written: the frozen
``ssm_scan_bound_s`` at batch 1, the prompt's length, d_inner and N, in
float32 as the model hands the scan its inputs) over the device time of
the ``ssm_scan`` forward kernels in the traced window."""
from harness.yardstick import Sizes, share, ssm_scan_bound_s


def read(run):
    t, reqs = run.trace, run.counters.get("requests")
    if t is None or not reqs:
        return None
    s = Sizes.of(run.config["model"])
    if s.family != "ssm":
        return None
    bound = sum(ssm_scan_bound_s(1, plen, s.d_inner, s.ssm_state) for plen, _ in reqs)
    return share(bound * s.n_layers, t.seconds_of("ssm_scan_forward"))
