"""The card a run measures: the check that it is there, its name and
power limit, clocks sampled beside the window, and peak memory.

Every line here goes to standard output before the result's line, which
carries only the result's own fields.
"""
from __future__ import annotations

import shutil
import subprocess
import sys
from typing import Dict, List, Optional

QUERY = "name,power.limit,clocks.sm,clocks.max.sm,power.draw,temperature.gpu"


class NoCard(RuntimeError):
    """The cell asks for more cards than this machine shows."""


def require_cards(torch, chips: int) -> None:
    """Raise :class:`NoCard` unless CUDA is there with ``chips`` cards."""
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: this benchmark runs only on the card")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell asks for {chips} cards and torch sees "
                     f"{torch.cuda.device_count()}")


def smi(index: int = 0) -> Optional[Dict[str, str]]:
    """One ``nvidia-smi`` reading of card ``index`` (None where it cannot be
    read): name, power limit, SM clock and its maximum, power draw,
    temperature."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    try:
        out = subprocess.run([exe, f"--query-gpu={QUERY}", "--format=csv,noheader",
                              f"--id={index}"], capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0:
        return None
    values = [v.strip() for v in out.stdout.strip().split(",")]
    return dict(zip(QUERY.split(","), values))


def describe(torch, chips: int) -> str:
    """The run-details line: card name, count, power limit."""
    reading = smi() or {}
    return (f"[card] {torch.cuda.get_device_name(0)}, {chips} of "
            f"{torch.cuda.device_count()} in use, power limit "
            f"{reading.get('power.limit', 'not read')}, torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}")


class ClockLog:
    """``nvidia-smi`` readings taken beside the window (before and after
    it: a reader inside it would share the host with the program)."""

    def __init__(self) -> None:
        self.readings: List[tuple] = []

    def sample(self, when: str) -> None:
        self.readings.append((when, smi()))

    def lines(self) -> List[str]:
        out = []
        for when, r in self.readings:
            if r is None:
                out.append(f"[clocks] {when}: nvidia-smi not read")
            else:
                out.append(f"[clocks] {when}: SM {r.get('clocks.sm')} of "
                           f"{r.get('clocks.max.sm')}, draw {r.get('power.draw')} of "
                           f"{r.get('power.limit')}, {r.get('temperature.gpu')} C")
        return out


def peak_bytes(torch, chips: int) -> int:
    """The peak of allocated memory on the fullest card in use."""
    return max(int(torch.cuda.max_memory_allocated(i)) for i in range(chips))


def say(line: str) -> None:
    print(line, flush=True)


def warn(line: str) -> None:
    print(line, file=sys.stderr, flush=True)
