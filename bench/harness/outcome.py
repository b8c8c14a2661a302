"""What one run of a cell hands back, and the comparisons that decide
``correct``."""
from __future__ import annotations

import gc
import math
import statistics
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .trace import Trace


@dataclass
class Outcome:
    setup_s: float
    window_s: float
    end_to_end: Dict[str, float]
    attempted: int
    failed: int
    checks: Dict[str, Tuple[float, float]]   # name -> (value, limit)
    memory_peak_bytes: int
    counters: Dict[str, Any] = field(default_factory=dict)
    trace: Optional[Trace] = None
    config: Dict[str, Any] = field(default_factory=dict)
    job: Dict[str, Any] = field(default_factory=dict)
    details: List[str] = field(default_factory=list)

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(math.isfinite(v) and v <= lim
                                        for v, lim in self.checks.values())


def set_up_phases(t0: float, marks: List[Tuple[str, float]], t_window: float) -> str:
    """The set-up's seconds by phase, from process start to the window."""
    parts, last = [], t0
    for name, t in marks + [("to the window", t_window)]:
        parts.append(f"{name} {t - last:.3f} s")
        last = t
    return "[setup] " + "; ".join(parts)


def leaf_gaps(program: Dict[str, float], reference: Dict[str, float],
              leaves: Optional[List[str]] = None) -> Dict[str, float]:
    """Each leaf's gap between the program's norm and the reference's,
    against the reference's norm of that leaf or of the median leaf,
    whichever is larger (inf where the program's norm is not finite)."""
    names = leaves if leaves is not None else list(reference)
    median = statistics.median(reference[n] for n in names)
    out = {}
    for n in names:
        gap = abs(program.get(n, float("nan")) - reference[n]) / max(reference[n], median, 1e-30)
        out[n] = gap if math.isfinite(gap) else float("inf")
    return out


def moving_leaves(ref_grad: Dict[str, float], share: float = 1e-3) -> List[str]:
    """Leaves whose reference gradient is at least ``share`` of the median
    leaf's: the others move under AdamW by round-off alone."""
    median = statistics.median(ref_grad.values())
    return [n for n, g in ref_grad.items() if g >= share * median]


def numbers_of(compared) -> Dict[str, float]:
    """Every number a comparison read (``train.compare``'s second value)."""
    return dict(compared[1]["numbers"])


def free(torch, device) -> None:
    """Give back the memory of what was just deleted."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
