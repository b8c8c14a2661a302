"""A run with its timed path broken underneath must read ``correct`` false.

Each test skips the look for a card and drives the rest of a run on the
CPU at the SMOKE sizes (parameters in float32, so a sound run sits far
inside the limits), once sound and once with each fault the cell can
have: a training step that returns its state unchanged; a training step
on half of its batch, the mean taken over the rest; a served token altered
where it is produced.  (Both cells run on one card: there is no exchange
between cards to leave out.)"""
import time

import pytest
import torch

from harness import cell as run_cell
from harness import device as dev

from conftest import FLOAT32, SERVE, TRAIN, small_cell


def run(name, tmp_path, hook=None, seed=4_000_000_017):
    cell = small_cell(name, FLOAT32)
    return run_cell.drive(cell, seed, 0.3, False, time.perf_counter(), torch.device("cpu"),
                          dev.ClockLog(), hook, bench=tmp_path / "bench")


def unchanged(trainer):
    def step(params, opt_state, batch):
        _, _, metrics = trainer.region(params, opt_state, batch)
        return params, opt_state, metrics
    return step


def half_batch(trainer):
    def step(params, opt_state, batch):
        half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        return trainer.region(params, opt_state, half)
    return step


def test_a_sound_training_run_is_correct(tmp_path):
    out = run(TRAIN, tmp_path)
    assert out.correct, out.checks
    assert out.attempted >= 1 and out.failed == 0


@pytest.mark.parametrize("fault", [unchanged, half_batch], ids=["state_unchanged", "half_batch"])
def test_a_broken_training_step_is_not_correct(fault, tmp_path):
    out = run(TRAIN, tmp_path, fault)
    assert not out.correct, out.checks


def test_a_sound_serving_run_is_correct(tmp_path):
    out = run(SERVE, tmp_path)
    assert out.correct, out.checks
    assert out.attempted >= 4 and out.failed == 0


def test_a_token_altered_where_it_is_produced_is_not_correct(tmp_path, monkeypatch):
    import repro_torch.runtime.engine as engine_mod

    real = engine_mod.greedy

    def altered(logits):
        tok = real(logits)
        return (tok + 1) % logits.shape[-1]

    monkeypatch.setattr(engine_mod, "greedy", altered)
    out = run(SERVE, tmp_path)
    assert not out.correct, out.checks
    assert out.checks["widest_gap"][0] > out.checks["widest_gap"][1]
