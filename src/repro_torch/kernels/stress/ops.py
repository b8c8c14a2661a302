"""AT region and KernelSpec for the stress kernel.

``stress_region()`` brackets the kernel's (block_k, block_j) family as the
paper brackets Seism3D's ``update_stress`` loop nest; the family is emitted
from the card's ArchSpec (core/emit.py).  Both tunables are grid splits
(one CTA per tile, no shared memory); the hint ranks the points that
leave SMs without a CTA last.  The traffic model counts what the kernel
moves, 17 fields read and 6 written, for the hint and for the bound alike.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

from ...core import ATRegion, BasicParams, KernelSpec, register_kernel
from ...core.arch import CPU_HOST, ArchSpec, local_arch
from ...core.emit import TileDim, TilePolicy, hint_prescreen
from .ref import stress_ref
from .stress import stress, traffic


STRESS_POLICY = TilePolicy(
    kernel="stress",
    dims=lambda bp: (
        TileDim("block_k", bp["nk"], semantic="grid"),
        TileDim("block_j", bp["nj"], semantic="grid"),
    ),
    # no shared memory: every value is read once, into registers
    vmem_model=lambda bp, p: 0,
    traffic_model=lambda bp, p: traffic(bp["nk"], bp["nj"], bp["ni"]),
)


def stress_region(
    dims=(256, 256, 256),
    arch: Optional[ArchSpec] = None,
) -> ATRegion:
    nk, nj, ni = dims
    arch = arch or local_arch()
    emitted = STRESS_POLICY.emit(arch, {"nk": nk, "nj": nj, "ni": ni})

    def instantiate(point: Mapping[str, Any]):
        bk, bj = point["block_k"], point["block_j"]
        return lambda inp: stress(inp, block_k=bk, block_j=bj)

    return ATRegion(
        "stress_cuda", emitted.space, instantiate, oracle=stress_ref,
        space_signature=emitted.signature, hints=emitted.hints, arch=arch,
    )


def shape_class(inp) -> BasicParams:
    """The DB key.  ``framework`` and a ``backend`` of ``cuda``/``cpu``
    keep the port's keys apart from the JAX package's in a shared file."""
    nk, nj, ni = inp["Sxx"].shape
    return BasicParams.make(
        kernel="stress",
        nk=int(nk),
        nj=int(nj),
        ni=int(ni),
        dtype=str(inp["Sxx"].dtype).replace("torch.", ""),
        backend=inp["Sxx"].device.type,
        framework="torch",
    )


def _make_region(bp: BasicParams) -> ATRegion:
    arch = local_arch() if bp["backend"] == "cuda" else CPU_HOST
    return stress_region(dims=(bp["nk"], bp["nj"], bp["ni"]), arch=arch)


register_kernel(
    KernelSpec(
        "stress",
        make_region=_make_region,
        shape_class=shape_class,
        prescreen_factory=hint_prescreen,
        tags=("cuda",),
    ),
    replace=True,
)
