"""``train_mfu``: the whole training step's share of the card's bf16 peak.

The useful FLOPs of every step completed in the window (the frozen
``step_flops(config, "train", batch, seq)``: 6·N·D over the active
parameters plus causal attention, with no recompute counted) over the
window's host-clock seconds at 989 TFLOP/s.  The card's power limit is on
the run's ``[card]`` line."""
from harness.yardstick import PEAK_BF16_FLOPS, Sizes, step_flops


def read(run):
    c = run.counters
    if not c.get("steps") or not run.window_s:
        return None
    flops = step_flops(Sizes.of(run.config["model"]), "train", c["batch"], c["seq"]) * c["steps"]
    return 100.0 * flops / (run.window_s * PEAK_BF16_FLOPS)
