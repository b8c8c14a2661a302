"""The control: the reference computed in 8-bit floats, the precision below
the configurations' bfloat16, put in the program's place, must come out
not correct where the program comes out correct.

On the CPU at the SMOKE sizes the control's readings stand well above the
program's; on the card (``card`` marker) at each cell's own size, on three
seeds, the control fails one of the cell's limits at least, and the
program none (``bench/calibrate.py`` takes the same readings on a dozen
seeds)."""
import torch

import pytest

from harness import control, manifest

from conftest import SERVE, TRAIN, small_cell

SEEDS = (4_100_000_001, 4_100_000_002, 4_100_000_003)


def test_training_control_stands_above_the_program_on_the_cpu(tmp_path):
    cell = small_cell(TRAIN)
    rows = control.readings(cell, SEEDS[:2], SEEDS[:2], torch.device("cpu"),
                            say=lambda line: None, cache=tmp_path)
    for row in rows:
        assert row["unchanged"]["update_gap"] == pytest.approx(1.0)
        ratios = [row["control"][k] / max(row["program"][k], 1e-12) for k in row["program"]]
        assert max(ratios) >= 3, row


def test_serving_control_stands_above_the_program_on_the_cpu(tmp_path):
    # wider than SMOKE, so the top logits lie close enough for 8-bit rounding to flip them
    cell = small_cell(SERVE)
    cell.config["model"].update(d_model=128, vocab_size=8192, dt_rank=8)
    cell.job.update(prompt={"law": "log-uniform", "min": 32, "max": 128, "multiple": 32},
                    answer={"min": 8, "max": 16}, sample={"served_tokens": 40})
    rows = control.readings(cell, SEEDS[:2], SEEDS[:2], torch.device("cpu"),
                            say=lambda line: None, cache=tmp_path)
    for row in rows:
        assert row["served_tokens"] >= cell.job["sample"]["served_tokens"]
        assert row["control"]["widest_gap"] > 3 * row["program"]["widest_gap"], row


@pytest.mark.card
@pytest.mark.parametrize("name", [TRAIN, SERVE])
def test_the_control_fails_a_limit_at_the_cells_own_size(name, card):
    cell = manifest.find_cell(name)
    rows = control.readings(cell, SEEDS, SEEDS, card)
    limits = cell.job["checks"]
    for row in rows:
        assert all(v <= limits[k] for k, v in row["program"].items()), row
        assert any(v > limits[k] for k, v in row["control"].items()), row
