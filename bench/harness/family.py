"""A configuration's plain reference, found by name.

A configuration file names its reference module under ``reference``:
``"reference": "moe_lm"`` is ``reference/moe_lm.py``.  Every reference
module has ``layout(m)``, the weight tree the benchmark draws; a training
cell takes its ``loss`` (through :func:`reference.training.follow`), a
serving cell its ``logits_at``, and a run prints what its ``notes``, where
it has them, read.  ``m`` is the configuration's ``model`` block with the
sizes it leaves to be derived (:func:`sizes`).  A configuration of another
family is added as a configuration file and, where no module fits it, a
reference module: no file of the harness changes.
"""
from __future__ import annotations

import importlib
from types import ModuleType
from typing import Any, Dict

from .manifest import NAME
from .yardstick import Sizes


def reference_of(config: Dict[str, Any]) -> ModuleType:
    """The module ``reference/<config["reference"]>.py``."""
    name = config["reference"]
    if not NAME.match(name) or "." in name:
        raise ValueError(f"reference module name {name!r}")
    return importlib.import_module(f"reference.{name}")


def sizes(config: Dict[str, Any]) -> Dict[str, Any]:
    """The ``model`` block with the sizes it leaves to be derived."""
    s = Sizes.of(config["model"])
    return dict(config["model"], head_dim=s.head_dim_, d_inner=s.d_inner, dt_rank=s.dt_rank_)
