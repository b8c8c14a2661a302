"""A Trainer that is done with leaves nothing behind: the registry keeps
its train-step spec (``train_step/<arch>``), whose closures hold the
remat cell and not the Trainer, so the Trainer and its final parameters
are collected once its caller drops it.  On the card those parameters
stayed allocated (``chip_smoke.py``'s restart drills left recurrentgemma-2b's
3 layers and tinyllama-1.1b's 2 on the card for the rest of the run)."""
from __future__ import annotations

import gc
import weakref

import pytest

from repro_torch.configs import get_config
from repro_torch.core import REGISTRY, TuningDB
from repro_torch.data import SyntheticLMDataset
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import Trainer, TrainLoopConfig

from test_torch_serve_common import restore_port_registry  # noqa: F401


@pytest.mark.parametrize("joint", [False, True])
def test_a_finished_trainer_is_collected(joint):
    cfg = get_config("tinyllama-1.1b", smoke=True)
    loop = TrainLoopConfig(total_steps=2, seed=0, microbatch_candidates=(1, 2),
                           joint_tune=joint, joint_cap=4)
    trainer = Trainer(cfg, AdamWConfig(total_steps=2), loop, tuning_db=TuningDB(),
                      device="cpu")
    hist = trainer.run(SyntheticLMDataset(cfg, 2, 16, seed=0))
    assert len(hist["loss"]) == 2 and trainer._final_params is not None
    alive = weakref.ref(trainer)
    del trainer
    gc.collect()
    assert alive() is None
    # the registry's spec still builds a step
    region = REGISTRY.get(f"train_step/{cfg.name}").make_region(None)
    assert callable(region.instantiate({"n_micro": 1}))
