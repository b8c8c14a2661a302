"""Fixtures of the benchmark's own tests: ``python -m pytest -q bench/tests``.

Tests that need the card carry the ``card`` marker and take the ``card``
fixture, which skips them where torch sees no CUDA device.  The rest run
on the CPU at the SMOKE sizes of the two configurations, through the same
runners a run takes on the card.
"""
import copy
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

# the SMOKE sizes of repro_torch/configs (granite-moe-smoke, falcon-mamba-7b-smoke)
SMOKE_MODEL = {
    "granite-moe-1b-a400m": dict(name="granite-moe-smoke", n_layers=2, d_model=64, n_heads=4,
                                 n_kv_heads=2, d_ff=48, vocab_size=256, n_experts=8, top_k=2),
    "falcon-mamba-7b": dict(name="falcon-mamba-7b-smoke", n_layers=2, d_model=64,
                            vocab_size=256, ssm_state=4, dt_rank=4),
}
SMOKE_JOB = {
    "train": dict(batch=2, seq=32),
    "serve": dict(batch_requests=4, prompt={"law": "log-uniform", "min": 16, "max": 64,
                                            "multiple": 16},
                  answer={"min": 2, "max": 4}, pool_rows=4, sample={"served_tokens": 8}),
}
FLOAT32 = {"params": "float32"}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped where there is none")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run these on the chip")
    return torch.device("cuda:0")


def small_cell(name: str, precision=None):
    """Cell ``name`` at its configuration's SMOKE sizes and a small job."""
    from harness import manifest

    cell = manifest.find_cell(name)
    cell.config = copy.deepcopy(cell.config)
    cell.config["model"].update(SMOKE_MODEL[cell.entry["config"]])
    if precision is not None:
        cell.config["precision"] = dict(precision)
    cell.job = dict(copy.deepcopy(cell.job), **SMOKE_JOB[cell.job["kind"]])
    return cell


@pytest.fixture
def smoke():
    return small_cell


TRAIN = "granite-moe-1b-a400m.train_4k"
SERVE = "falcon-mamba-7b.serve_long"
