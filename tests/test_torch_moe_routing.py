"""``chip_smoke.MoeRouting``, on the CPU: the gradient check's replay of one
route's expert picks on another keeps each (layer, group)'s picks apart,
so a layer that dispatches its tokens in ``moe_groups`` groups replays
every group's own picks, and a replay that finds no recorded picks, or
leaves some unread, raises."""
from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch import models as tm
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.runtime.train import _loss_and_grads, batch_tensors
from repro_torch.tree import as_tree, flatten

ROOT = Path(__file__).resolve().parents[1]


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def setup(groups: int, remat: str = "full", B: int = 2, S: int = 16):
    cs = chip_smoke()
    cfg = get_config("granite-moe-1b-a400m", smoke=True).with_(moe_groups=groups, remat=remat)
    tree = as_tree(tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    leaves, structure = flatten(tree)
    routing = cs.MoeRouting(cfg)
    routing.bind(leaves, cs.leaf_names(tree))
    batch = batch_tensors(SyntheticLMDataset(cfg, B, S, seed=0).batch(0), "cpu")
    return cfg, leaves, structure, routing, batch


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("groups", [1, 2, 4])
def test_each_group_replays_its_own_picks(groups, remat):
    cfg, leaves, structure, routing, batch = setup(groups, remat)
    routing.record()
    with routing:
        loss, grads = _loss_and_grads(leaves, structure, batch, cfg)
    routers = {layer for layer, _ in routing.picks}
    assert len(routers) == cfg.n_layers
    assert set(routing.picks) == {(r, g) for r in routers for g in range(groups)}
    if groups > 1:  # the groups' tokens differ, so do their picks
        r = sorted(routers)[0]
        assert not torch.equal(routing.picks[(r, 0)], routing.picks[(r, 1)])
    with routing:  # the same route on its own picks: nothing parts
        again, grads2 = _loss_and_grads(leaves, structure, batch, cfg)
    assert routing.parted == 0
    runs = 2 if remat == "full" else 1  # the recompute dispatches again
    assert routing.picked == runs * cfg.n_layers * batch["tokens"].numel()
    assert float(again) == float(loss)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2))


def test_a_replay_without_its_picks_raises():
    cfg, leaves, structure, routing, batch = setup(2)
    routing.record()
    with routing:
        _loss_and_grads(leaves, structure, batch, cfg)
    half = {k: v[:1] for k, v in batch.items()}  # other group sizes
    with pytest.raises(RuntimeError, match="no recorded picks"):
        with routing:
            _loss_and_grads(leaves, structure, half, cfg)
