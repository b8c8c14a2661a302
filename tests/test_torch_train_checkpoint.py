"""The port's checkpoints: roundtrip, keep-N rotation, the ``.tmp`` then
``os.replace`` discipline, and the format shared with the JAX package: a
checkpoint the port writes loads in ``repro.checkpoint.load_checkpoint``
and one the JAX package writes loads in the port, leaf for leaf, bf16
included (stored as its bits in a ``u2`` view)."""
from __future__ import annotations

import json
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jax_load, save_checkpoint as jax_save
from repro_torch.checkpoint import (
    CheckpointManager, latest_step_dir, load_checkpoint, save_checkpoint,
)
from repro_torch.checkpoint import manager as manager_mod


def _torch_tree():
    g = torch.Generator().manual_seed(0)
    return {
        "p": {"layers": [{"w": torch.randn(3, 4, generator=g).to(torch.bfloat16),
                          "b": torch.randn(4, generator=g)} for _ in range(2)],
              "embed": torch.randn(5, 2, generator=g).to(torch.bfloat16)},
        "o": {"count": torch.tensor(7, dtype=torch.int32),
              "m": torch.randn(2, 2, generator=g)},
    }


def _as_jax(tree):
    if isinstance(tree, dict):
        return {k: _as_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_jax(v) for v in tree]
    if tree.dtype == torch.bfloat16:
        return jnp.asarray(tree.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(tree.numpy())


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _bits(x):
    """A leaf's dtype name and raw bytes, either package's."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return "bfloat16", x.view(torch.int16).numpy().tobytes()
        return str(x.numpy().dtype), x.numpy().tobytes()
    a = np.asarray(x)
    return str(a.dtype), a.tobytes()


def test_checkpoint_roundtrip(tmp_path):
    tree = _torch_tree()
    path = save_checkpoint(str(tmp_path), 42, tree)
    step, restored = load_checkpoint(path, tree)
    assert step == 42
    for a, b in zip(_leaves(tree), _leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    manifest = json.loads((tmp_path / "step_00000042" / "manifest.json").read_text())
    assert manifest["format"] == 1 and manifest["n_leaves"] == 7
    assert manifest["dtypes"].count("bfloat16") == 3


def test_checkpoint_rotation(tmp_path):
    mgr = CheckpointManager(str(tmp_path), save_every=1, keep=2)
    tree = {"x": torch.zeros(2)}
    for s in range(1, 6):
        mgr.maybe_save(s, tree, force=True)
    assert sorted(os.listdir(tmp_path)) == ["step_00000004", "step_00000005"]
    assert mgr.maybe_save(7, tree) is not None
    assert CheckpointManager(str(tmp_path), save_every=2).maybe_save(7, tree) is None
    assert mgr.restore_latest(tree)[0] == 7


def test_a_crash_mid_save_leaves_the_latest_checkpoint(tmp_path, monkeypatch):
    tree = {"x": torch.arange(3.0)}
    save_checkpoint(str(tmp_path), 2, tree)

    def crash(*a, **k):
        raise OSError("disk lost mid-save")

    monkeypatch.setattr(manager_mod.np, "savez", crash)
    with pytest.raises(OSError):
        save_checkpoint(str(tmp_path), 4, {"x": torch.zeros(3)})
    # the torn save is a .tmp directory, never a step the loader picks
    assert sorted(os.listdir(tmp_path)) == ["step_00000002", "step_00000004.tmp"]
    assert latest_step_dir(str(tmp_path)).endswith("step_00000002")
    monkeypatch.undo()
    save_checkpoint(str(tmp_path), 4, {"x": torch.zeros(3)})  # the next save clears it
    assert sorted(os.listdir(tmp_path)) == ["step_00000002", "step_00000004"]


def test_port_checkpoint_loads_in_the_jax_package(tmp_path):
    tree = _torch_tree()
    path = save_checkpoint(str(tmp_path), 3, tree)
    step, restored = jax_load(path, _as_jax(tree))
    assert step == 3
    got = _leaves(restored)
    assert [np.asarray(x).dtype for x in got].count(np.dtype(ml_dtypes.bfloat16)) == 3
    for a, b in zip(_leaves(tree), got):
        assert _bits(a) == _bits(b)


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    tree = _torch_tree()
    path = jax_save(str(tmp_path), 5, _as_jax(tree))
    step, restored = load_checkpoint(path, tree)
    assert step == 5
    for a, b in zip(_leaves(tree), _leaves(restored)):
        assert a.dtype == b.dtype and _bits(a) == _bits(b)
