"""``serve_mfu``: the whole serving work's share of the card's bf16 peak.

The useful FLOPs of every request completed in the window, its prefill
(the frozen ``step_flops(config, "prefill", 1, prompt)``) and each decode
step after its first token (``step_flops(config, "decode", 1, context)``),
over the window's host-clock seconds at 989 TFLOP/s."""
from harness.yardstick import PEAK_BF16_FLOPS, Sizes, step_flops


def read(run):
    reqs = run.counters.get("requests")
    if not reqs or not run.window_s:
        return None
    s = Sizes.of(run.config["model"])
    flops = 0.0
    for plen, served in reqs:
        flops += step_flops(s, "prefill", 1, plen)
        flops += sum(step_flops(s, "decode", 1, plen + j) for j in range(1, served))
    return 100.0 * flops / (run.window_s * PEAK_BF16_FLOPS)
