"""Production mesh construction.

The port of ``repro.launch.mesh``.  Functions, not module-level constants:
importing this module starts nothing.  The dry-run's mesh lives on a
``fake`` process group (``torch.testing._internal.distributed.fake_pg``):
one process plays rank 0 of the whole world, collectives return at once
and move nothing, and DTensors on it hold fake tensors, so a 512-device
step is traced on the CPU with nothing allocated.  JAX forces 512 host
devices through ``XLA_FLAGS`` before its first import; the port needs no
environment variable, and :func:`make_production_mesh` starts the group
in the process that calls it.

Topology:
* single pod:  (data=16, model=16) = 256 devices
* multi-pod:   (pod=2, data=16, model=16) = 512 devices; ``pod`` is the
  outermost axis, so its groups span nodes.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

from ..distributed.sharding import Mesh


def start_fake_group(world_size: int) -> None:
    """Make this process rank 0 of a ``fake`` process group of
    ``world_size`` ranks.  A fake group of another size is replaced; a real
    group is left alone and refused."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is running: the dry-run needs a fake one")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False,
                         shape: Optional[Tuple[int, ...]] = None) -> Mesh:
    """The dry-run's mesh on a fake process group of its size.  ``shape``
    overrides the default axis sizes (same axis names): the mesh
    factorization itself is a tunable degree PP, e.g. (32, 8) for
    llama4-scout, whose 40 attention heads do not divide model=16."""
    from torch.distributed.device_mesh import init_device_mesh

    default: Tuple[int, ...] = (2, 16, 16) if multi_pod else (16, 16)
    shape = tuple(shape) if shape is not None else default
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} must have {len(axes)} axes")
    start_fake_group(math.prod(shape))
    device_mesh = init_device_mesh("cpu", shape, mesh_dim_names=axes)
    return Mesh(dict(zip(axes, shape)), device_mesh)


def make_host_mesh(model: int = 1) -> Mesh:
    """A (data, model) mesh that names the devices this process has: the
    ranks of its process group if one runs, else one device.  It places
    nothing (no DeviceMesh); it keys tuned results to a factorization."""
    import torch.distributed as dist

    n = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    return Mesh({"data": max(1, n // model), "model": model})


def n_chips(mesh: Mesh) -> int:
    return mesh.size
