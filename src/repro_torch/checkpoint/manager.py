"""Checkpointing: atomic, restartable, in the JAX package's format.

The port of ``repro.checkpoint.manager``, byte for byte in layout:

    <dir>/step_0000400/
        manifest.json   # step, structure, leaf dtypes/shapes
        arrays.npz      # flattened leaves keyed "l<000i>"

written to ``<name>.tmp`` and then ``os.replace``d, so a crash mid-save
never corrupts the latest checkpoint.  Leaves are flattened in JAX's
pytree order (:mod:`repro_torch.tree`: dict keys sorted, lists by index)
and bf16 is stored as its raw bits in a ``u2`` view with ``"bfloat16"`` in
the manifest, so a checkpoint either package writes loads in the other.
Leaves are stored unsharded (one card); a loaded leaf lands on the device
of the matching leaf of ``like``.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..tree import flatten, unflatten

_STEP_RE = re.compile(r"^step_(\d{8})$")


def _to_numpy(leaf: Any) -> Tuple[np.ndarray, str]:
    """(array to store, dtype name for the manifest)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:  # no numpy bf16: its bits as u2
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def _from_numpy(a: np.ndarray, dtype: str, like: Any) -> torch.Tensor:
    if dtype == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, dtype=np.dtype(dtype)))
    device = like.device if isinstance(like, torch.Tensor) else "cpu"
    return t.to(device)


def save_checkpoint(directory: str, step: int, tree: Any) -> str:
    """Atomically write ``tree`` (a tree of tensors or arrays) for ``step``."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    leaves, structure = flatten(tree)
    arrays, dtypes = {}, []
    for i, leaf in enumerate(leaves):
        a, dtype = _to_numpy(leaf)
        arrays[f"l{i:05d}"] = a
        dtypes.append(dtype)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "n_leaves": len(leaves),
        "treedef": json.dumps(structure),
        "dtypes": dtypes,
        "shapes": [list(a.shape) for a in arrays.values()],
        "format": 1,
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def load_checkpoint(path: str, like: Any) -> Tuple[int, Any]:
    """Load a checkpoint dir into the structure of ``like``, each leaf on
    the device of ``like``'s leaf."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves_like, structure = flatten(like)
    if len(leaves_like) != manifest["n_leaves"]:
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, expected {len(leaves_like)}"
        )
    with np.load(os.path.join(path, "arrays.npz")) as z:
        leaves = [_from_numpy(z[f"l{i:05d}"], manifest["dtypes"][i], leaves_like[i])
                  for i in range(manifest["n_leaves"])]
    return manifest["step"], unflatten(structure, leaves)


def latest_step_dir(directory: str) -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    best: Optional[Tuple[int, str]] = None
    for name in os.listdir(directory):
        m = _STEP_RE.match(name)
        if m:
            s = int(m.group(1))
            if best is None or s > best[0]:
                best = (s, os.path.join(directory, name))
    return best[1] if best else None


class CheckpointManager:
    """Keep-N rotation + resume discovery + save cadence."""

    def __init__(self, directory: str, save_every: int = 100, keep: int = 3) -> None:
        self.directory = directory
        self.save_every = save_every
        self.keep = keep

    def maybe_save(self, step: int, tree: Any, force: bool = False) -> Optional[str]:
        if not force and (step == 0 or step % self.save_every):
            return None
        path = save_checkpoint(self.directory, step, tree)
        self._rotate()
        return path

    def restore_latest(self, like: Any) -> Optional[Tuple[int, Any]]:
        path = latest_step_dir(self.directory)
        if path is None:
            return None
        return load_checkpoint(path, like)

    def _rotate(self) -> None:
        steps: List[Tuple[int, str]] = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m:
                steps.append((int(m.group(1)), os.path.join(self.directory, name)))
        steps.sort()
        for _, path in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(path, ignore_errors=True)
