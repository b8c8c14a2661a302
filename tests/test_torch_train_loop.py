"""The port's training loop on the CPU: ``SyntheticLMDataset`` array for
array equal to the JAX package's; the ``Trainer`` runs with finite losses,
resumes from its checkpoint after a ``SimulatedFailure`` with losses equal
bit for bit to an uninterrupted run's, tunes (microbatch degree × remat)
jointly and a second Trainer on the same TuningDB recalls the winner with
0 evaluations (the counterparts of ``tests/test_runtime.py:100-147`` and
``tests/test_program.py:454``); the train CLI runs on ``--device cpu``;
and fleet keying keys the step as the JAX package's does."""
from __future__ import annotations

import contextlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data import SyntheticLMDataset as JaxDataset
from repro_torch.configs import get_config
from repro_torch.core import TuningDB
from repro_torch.data import SyntheticLMDataset
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import SimulatedFailure, Trainer, TrainLoopConfig
from repro_torch.tree import flatten
from test_torch_serve_common import restore_port_registry  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent
SMOKE = get_config("tinyllama-1.1b", smoke=True)


def _loop_cfg(tmp_path, **kw):
    d = dict(total_steps=6, log_every=100, ckpt_dir=str(tmp_path / "ckpt"), save_every=2,
             n_microbatches=1, microbatch_candidates=(1, 2))
    d.update(kw)
    return TrainLoopConfig(**d)


def _opt_cfg():
    return AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-vl-2b", "whisper-large-v3"])
def test_dataset_equals_jax(arch):
    port = SyntheticLMDataset(get_config(arch, smoke=True), global_batch=4, seq_len=32, seed=7)
    jax_ds = JaxDataset(jax_config(arch, smoke=True), global_batch=4, seq_len=32, seed=7)
    for step in (0, 3):
        for host in (0, 1):
            got = port.batch(step, host_id=host, n_hosts=2)
            want = jax_ds.batch(step, host_id=host, n_hosts=2)
            assert sorted(got) == sorted(want)
            for key in want:
                assert got[key].dtype == want[key].dtype
                np.testing.assert_array_equal(got[key], want[key])


def test_train_loop_runs_and_loss_finite(tmp_path):
    trainer = Trainer(SMOKE, _opt_cfg(), _loop_cfg(tmp_path), device="cpu")
    hist = trainer.run(SyntheticLMDataset(SMOKE, global_batch=2, seq_len=32))
    assert len(hist["loss"]) == 6 and hist["step"] == list(range(6))
    assert all(np.isfinite(x) for x in hist["loss"])
    assert sorted(os.listdir(tmp_path / "ckpt")) == [
        "step_00000002", "step_00000004", "step_00000006"]


def test_failure_recovery_resumes_from_checkpoint_bit_identical(tmp_path):
    """Kill the job at step 5; the restarted loop resumes from the step-4
    checkpoint and its losses equal an uninterrupted run's bit for bit."""
    ds = SyntheticLMDataset(SMOKE, global_batch=2, seq_len=32)
    ref = Trainer(SMOKE, _opt_cfg(), _loop_cfg(tmp_path / "ref"), device="cpu").run(ds)
    fired = []

    def failure_hook(step):
        if step == 5 and not fired:
            fired.append(step)
            raise SimulatedFailure("node lost")

    trainer = Trainer(SMOKE, _opt_cfg(), _loop_cfg(tmp_path / "ft"), device="cpu")
    hist = trainer.run(ds, failure_hook=failure_hook)
    assert trainer.restarts == 1
    assert hist["step"] == [0, 1, 2, 3, 4, 4, 5]  # step 4 re-run from its checkpoint
    assert hist["loss"][:5] + hist["loss"][6:] == ref["loss"][:5] + ref["loss"][5:6]
    assert hist["loss"][5] == ref["loss"][4]


def test_trainer_joint_tune_then_recall():
    db = TuningDB()
    loop = TrainLoopConfig(total_steps=1, n_microbatches=1, microbatch_candidates=(1, 2),
                           joint_tune=True)
    ds = SyntheticLMDataset(SMOKE, global_batch=4, seq_len=16, seed=7)
    trainer = Trainer(SMOKE, _opt_cfg(), loop, tuning_db=db, device="cpu")
    hist = trainer.run(ds)
    assert len(hist["loss"]) == 1
    r = trainer.joint_result
    assert r is not None and not r.from_cache and r.evaluations > 0
    assert set(r.assignment) == {"micro", "remat"}
    assert trainer.region.selected == {"n_micro": r.assignment["micro"]["n_micro"]}
    assert trainer._step_remat == r.assignment["remat"]["remat"]
    assert trainer._warmed == {1, 2}  # every degree's shape classes met before measuring

    trainer2 = Trainer(SMOKE, _opt_cfg(), loop, tuning_db=db, device="cpu")
    r2 = trainer2.joint_tune(ds)
    assert r2.from_cache and r2.evaluations == 0 and r2.assignment == r.assignment
    assert trainer2.region.selected == trainer.region.selected
    assert trainer2._warmed == set()  # a recall measures nothing, so warms nothing


def test_joint_tune_runs_each_measured_step_inside_the_trial_hook():
    """``trial(n_micro, remat)`` wraps every step the joint search measures
    (a caller reads each assignment's memory and launches there), and
    nothing else: not the warm steps, not a recall."""
    seen = []

    @contextlib.contextmanager
    def trial(n, remat):
        seen.append((n, remat))
        yield

    db = TuningDB()
    loop = TrainLoopConfig(total_steps=1, n_microbatches=1, microbatch_candidates=(1, 2),
                           joint_tune=True)
    ds = SyntheticLMDataset(SMOKE, global_batch=4, seq_len=16, seed=7)
    r = Trainer(SMOKE, _opt_cfg(), loop, tuning_db=db, device="cpu").joint_tune(ds, trial=trial)
    # four assignments fit under the cap, so each is measured (the finalists
    # again): a warm-up run and at least one timed run an evaluation
    assert sorted(set(seen)) == [(1, "full"), (1, "none"), (2, "full"), (2, "none")]
    assert len(seen) >= 2 * r.evaluations and r.evaluations >= 4
    seen.clear()
    Trainer(SMOKE, _opt_cfg(), loop, tuning_db=db, device="cpu").joint_tune(ds, trial=trial)
    assert seen == []


def test_parameters_take_the_configs_dtype():
    loop = TrainLoopConfig(total_steps=1)
    for dtype in ("bfloat16", "float32"):
        trainer = Trainer(SMOKE.with_(dtype=dtype), _opt_cfg(), loop, device="cpu")
        params, state = trainer.init_state()
        leaves = flatten(params)[0]
        assert {t.dtype for t in leaves} == {getattr(torch, dtype)}
        assert {t.dtype for t in flatten(state["m"])[0]} == {torch.float32}


def test_device_key_waits_for_the_fleet():
    """The fleet is ported: ``device_key`` keys the train step by the
    training device's fingerprint, the same entries the JAX package adds on
    this host."""
    from repro.fleet import device_bp_entries as jax_device_entries

    trainer = Trainer(SMOKE, _opt_cfg(), TrainLoopConfig(device_key=True), device="cpu")
    (state,) = trainer.op.states().values()
    assert state.bp.fingerprint() == trainer.bp.fingerprint()
    keyed = {k: v for k, v in trainer.bp.asdict().items() if k.startswith("device_")}
    assert keyed == jax_device_entries()
    plain = Trainer(SMOKE, _opt_cfg(), TrainLoopConfig(), device="cpu")
    assert plain.bp.fingerprint() != trainer.bp.fingerprint()


def test_train_cli_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--arch", "tinyllama-1.1b", "--steps", "3", "--batch", "2", "--seq", "32"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "final loss" in out.stdout and "after 3 steps" in out.stdout
